"""The port's schedules against grafx_tpu's, node for node: the fixed and
one-by-one searches, the native C++ beam search (the port's own build)
against the numpy one and against grafx_tpu's, a cycle refused, and
``fuse_parameters`` with the scheduler's own arguments.  Mirrors
``tests/graph/test_order.py``."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render.order import compute_render_order as j_order
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch._native import beam_search_native, native_available
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.render import fuse_parameters, fuse_serial_lti, reorder_for_fast_render
from grafx_tpu_torch.render.order import (
    beam_search,
    compute_render_order,
    fixed_order_search,
    one_by_one_search,
)
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items
from test_torch_graph import FUSE, jax_graph, jax_processors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ("eq", "comp", "rev")


def random_dag(mod, seed, num_chains=4, chain_len=4, cross=False):
    """``tests/graph/test_order.py``'s console-style graph in either
    package (``mod`` gives ``GRAFX`` and ``NodeConfigs``), optionally with
    a second mix fed by some of the chains."""
    rng = np.random.default_rng(seed)
    G = mod[0](config=mod[1](list(TYPES)))
    ends = []
    for _ in range(num_chains):
        chain = ["in"] + [str(rng.choice(TYPES)) for _ in range(int(rng.integers(1, chain_len)))]
        ends.append(G.add_serial_chain(chain)[1])
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    last = mix
    if cross:
        mix2 = G.add("mix")
        for e in ends:
            if rng.random() < 0.5:
                G.connect(e, mix2)
        G.connect(mix, mix2)
        first, last = G.add_serial_chain([str(rng.choice(TYPES)), "mix"])
        G.connect(mix2, first)
    G.connect(last, G.add("out"))
    return G


PORT, REF = (GRAFX, NodeConfigs), (JGRAFX, JNodeConfigs)


def check_schedule(G_t, type_sequence, render_order):
    """A partition of the nodes into causal, type-homogeneous stages, with
    every "in" first and every "out" last."""
    T = np.asarray(G_t.node_types)
    render_order = np.asarray(render_order)
    assert (render_order >= 0).all()
    for i in range(render_order.max() + 1):
        nodes = np.where(render_order == i)[0]
        if len(nodes):
            assert (T[nodes] == type_sequence[i]).all()
    assert set(np.where(render_order == 0)[0]) == set(np.where(T == 0)[0])
    assert set(np.where(render_order == render_order.max())[0]) == set(np.where(T == 1)[0])
    E = np.asarray(G_t.edge_indices)
    assert (render_order[E[0]] < render_order[E[1]]).all()


def both_orders(seed, method, cross=False, **kw):
    G_t = convert_to_tensor(random_dag(PORT, seed, num_chains=5, chain_len=5, cross=cross))
    J_t = j_convert(random_dag(REF, seed, num_chains=5, chain_len=5, cross=cross))
    return G_t, compute_render_order(G_t, method=method, **kw), j_order(J_t, method=method, **kw)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("method", ["greedy", "beam", "one-by-one"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_matches_reference(seed, method, cross):
    G_t, (seq, order), (j_seq, j_order_) = both_orders(seed, method, cross=cross)
    check_schedule(G_t, seq, order)
    np.testing.assert_array_equal(seq, np.asarray(j_seq))
    np.testing.assert_array_equal(order, np.asarray(j_order_))


def test_one_by_one_is_serial():
    G = GRAFX(config=NodeConfigs(["eq"]))
    for _ in range(3):
        G.add_serial_chain(["in", "eq", "out"])
    G_t = convert_to_tensor(G)
    seq, order = one_by_one_search(G_t)
    assert (order == 0).sum() == 3  # the "in" nodes share stage 0
    for i in range(1, order.max() + 1):
        assert (order == i).sum() == 1
    T = np.asarray(G_t.node_types)
    np.testing.assert_array_equal(T[np.argsort(order)], np.asarray(seq)[np.sort(order)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fixed_order_of_beam_sequence_is_the_beam_schedule(seed):
    """The beam's own type sequence as ``fixed_order`` reproduces the beam
    schedule, and the reference's fixed search gives the same."""
    G_t, (seq, order), _ = both_orders(seed, "beam")
    f_seq, f_order = fixed_order_search(G_t, fixed_order=seq)
    np.testing.assert_array_equal(f_seq, seq)
    np.testing.assert_array_equal(f_order, order)
    _, _, (j_seq, j_order_) = both_orders(seed, "fixed", fixed_order=seq)
    np.testing.assert_array_equal(f_order, np.asarray(j_order_))


def test_fixed_order_two_stages_and_exhaustion():
    config = NodeConfigs(["eq", "comp"])
    G = GRAFX(config=config)
    _, last = G.add_serial_chain(["in", "eq", "comp"])
    G.connect(last, G.add("out"))
    G_t = convert_to_tensor(G)
    eq, comp = config.node_type_to_index["eq"], config.node_type_to_index["comp"]
    seq, order = compute_render_order(G_t, method="fixed", fixed_order=[0, eq, comp, 1])
    check_schedule(G_t, seq, order)
    np.testing.assert_array_equal(seq, [0, eq, comp, 1])
    with pytest.raises(RuntimeError, match="exhausted"):
        compute_render_order(G_t, method="fixed", fixed_order=[0, comp, eq])


def test_fixed_order_passes_through_reorder():
    G = random_dag(PORT, 5)
    seq, _ = compute_render_order(G, method="beam")
    G_t = reorder_for_fast_render(convert_to_tensor(G), method="fixed", fixed_order=seq)
    assert G_t.rendering_order_method == "fixed"
    check_schedule(G_t, [G_t.config.node_type_to_index[t] for t in G_t.type_sequence],
                   G_t.rendering_orders)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Invalid rendering method"):
        compute_render_order(random_dag(PORT, 0), method="random")


@pytest.mark.parametrize("width,depth", [(64, 1), (8, 1), (1, 1), (4, 2), (16, 3)])
def test_native_beam_matches_numpy(width, depth):
    """The port's C++ search gives the numpy search's schedule, stage for
    stage, on random graphs (grafx_tpu's test compares stage counts)."""
    assert native_available()
    for seed in range(6):
        G_t = convert_to_tensor(random_dag(PORT, seed, num_chains=5, chain_len=5, cross=seed % 2 == 1))
        native = beam_search_native(np.asarray(G_t.node_types), np.asarray(G_t.edge_indices),
                                    width=width, depth=depth)
        numpy_ = beam_search(G_t, width=width, depth=depth, use_native=False)
        check_schedule(G_t, *native)
        np.testing.assert_array_equal(native[0], numpy_[0])
        np.testing.assert_array_equal(native[1], numpy_[1])


def test_native_beam_large_graph():
    G_t = convert_to_tensor(random_dag(PORT, 0, num_chains=100, chain_len=8))
    seq, order = beam_search_native(np.asarray(G_t.node_types), np.asarray(G_t.edge_indices), width=16)
    check_schedule(G_t, seq, order)
    np.testing.assert_array_equal(order, beam_search(G_t, width=16, use_native=False)[1])


def cyclic_tensor():
    G = GRAFX(config=NodeConfigs(["a"]), invalid_op="mute")
    i, x, y, o = G.add("in"), G.add("a"), G.add("a"), G.add("out")
    G.connect(i, x), G.connect(x, y), G.connect(y, x), G.connect(y, o)
    return convert_to_tensor(G)


def test_native_beam_rejects_cycle():
    G_t = cyclic_tensor()
    assert beam_search_native(np.asarray(G_t.node_types), np.asarray(G_t.edge_indices)) is None
    with pytest.raises(RuntimeError, match="MAX_ITER"):
        beam_search(G_t)  # the numpy search's error


def test_native_build_is_the_ports_own():
    """The scheduler loads from the port's build directory, and never from
    grafx_tpu's ``_native/libscheduler.so``."""
    code = (
        "import numpy as np\n"
        "from grafx_tpu_torch._native import beam_search_native, _library_path\n"
        "assert beam_search_native(np.array([0, 2, 1]), np.array([[0, 1], [1, 2]])) is not None\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert _library_path() in maps, _library_path()\n"
        "assert 'grafx_tpu/_native' not in maps\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("order_kwargs", [{"width": 1}, {"width": 4, "depth": 2},
                                          {"use_native": False}])
def test_fuse_parameters_passes_order_kwargs(order_kwargs, monkeypatch):
    """``fuse_parameters(..., **order_kwargs)`` migrates on the schedule
    those arguments give, as grafx_tpu's does, for every fused leaf."""
    from grafx_tpu_torch.models.console import bench_graph, bench_processors

    G, procs = bench_graph(6), bench_processors()
    Gj, procs_j = jax_graph(6, monkeypatch), jax_processors()
    G2, procs2 = fuse_serial_lti(G, procs, **FUSE)
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j = jax.tree.map(np.asarray, j_create_params(procs_j, Gj, key=jax.random.PRNGKey(3)))
    got = fuse_parameters(parameters_from_numpy(params_j), G, G2, procs2, **order_kwargs)
    ref = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, **order_kwargs)
    ref = dict(tree_items(parameters_from_numpy(jax.tree.map(np.asarray, ref))))
    got = dict(tree_items(got))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
