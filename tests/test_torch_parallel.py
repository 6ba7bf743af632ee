"""grafx_tpu_torch.parallel on torch.distributed: every case of
tests/test_parallel.py (but the JAX-only dryrun entry point) at 2 and 4
gloo ranks on the CPU, with a (k/2, 2) mesh for the 2-D cases, each held
against the unsharded port (rtol 1e-5, atol 1e-6 for renders; rtol
2e-4, atol 1e-7 for gradients) and against grafx_tpu's sharded result on
the virtual mesh of tests/conftest.py (-60 dB for renders and for the
concatenated gradient, -40 dB for each leaf).  Also: the uneven node
split (17 chains, 9/8 over 2 ranks), a noise stage under node and batch
sharding, a batch that does not divide, the gradient counted once under
each sharding, and examples/multihost_dp.py's check.

Every rank of one world size runs every case in one spawn (a
module-scoped fixture); the ranks meet on a FileStore under a temporary
directory and write their results there.  The parent makes the inputs
and parameters (the JAX ones through numpy), and computes the unsharded
port and grafx_tpu's results.  A spawned rank re-imports this module,
so it imports neither jax nor grafx_tpu at its top.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from grafx_tpu_torch import parallel, random
from grafx_tpu_torch import data as tdata
from grafx_tpu_torch import processors as tproc
from grafx_tpu_torch.models import bench_console
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.render import make_render_fn, prepare_render, reorder_for_fast_render
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map

WORLDS = (2, 4)
L = 2**10
RENDER_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-7)
UNEVEN_CHAINS = 17
CONSOLE_CHAINS = 5  # bench.py's console on fsm equalizers, fused
MULTIHOST_L, MULTIHOST_STEPS, MULTIHOST_LR = 2**13, 3, 1e-2


# ---------------------------------------------------------------------------
# Graphs, in either package
# ---------------------------------------------------------------------------


def chains(pkg, num, chain, types, buses=None):
    """``num`` serial chains into one mix into the output; with ``buses``
    (a list of chain counts), each group of chains mixes into a gain bus
    and the buses into the output."""
    G = pkg.GRAFX(config=pkg.NodeConfigs(types))
    ends = [G.add_serial_chain(["in", *chain])[1] for _ in range(num)]
    if buses:
        groups, ends = ends, []
        for size in buses:
            mix = G.add("mix")
            for e in groups[:size]:
                G.connect(e, mix)
            groups = groups[size:]
            bus = G.add("gain")
            G.connect(mix, bus)
            ends.append(bus)
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


GRAPHS = {
    # name: (chains, chain, node types, processors)
    "setup": (3, ["gain", "compressor"], ["gain", "compressor"], lambda p: {
        "gain": p.StereoGain(), "compressor": p.Compressor(energy_smoother="iir", iir_len=512)}),
    "gain8": (8, ["gain"], ["gain"], lambda p: {"gain": p.StereoGain()}),
    "gain4": (4, ["gain"], ["gain"], lambda p: {"gain": p.StereoGain()}),
    "exact": (4, ["eq", "comp", "gain"], ["gain", "eq", "comp"], lambda p: {
        "gain": p.StereoGain(), "eq": p.ParametricEqualizer(num_filters=4, backend="exact"),
        "comp": p.Compressor(energy_smoother="ballistics")}),
    "multihost": (4, ["eq", "comp", "gain"], ["comp", "eq", "gain"], lambda p: {
        "comp": p.Compressor(energy_smoother="ballistics"),
        "eq": p.ParametricEqualizer(num_filters=4, backend="exact"), "gain": p.StereoGain()}),
    "uneven": (UNEVEN_CHAINS, ["gain", "comp"], ["gain", "comp"], lambda p: {
        "gain": p.StereoGain(), "comp": p.Compressor(energy_smoother="ballistics")}),
    "noise": (4, ["gain", "reverb"], ["gain", "reverb"], lambda p: {
        "gain": p.StereoGain(), "reverb": p.GainStagingRegularization(
            p.STFTMaskedNoiseReverb(ir_len=1000, fixed_noise=False))}),
    "buses": (12, ["gain", "comp"], ["gain", "comp"], lambda p: {
        "gain": p.StereoGain(), "comp": p.Compressor(energy_smoother="ballistics")}),
}
# the bus stage's rows read chains that other ranks computed
BUSES = {"buses": [5, 3, 2, 2]}


def port_graph(name):
    if name == "console":
        c = bench_console(CONSOLE_CHAINS, device="cpu", processors=bench_processors(backend="fsm"))
        return c.fused_processors, c.plan
    num, chain, types, make = GRAPHS[name]
    procs = make(tproc)
    plan = prepare_render(reorder_for_fast_render(
        tdata.convert_to_tensor(chains(tdata, num, chain, types, BUSES.get(name))), method="beam"))
    return procs, plan


# (case, graph, input shape, seed); every case renders its graph on these
CASES = {
    "data_render": ("setup", (16, 3, 2, L), 0),
    "data_grad": ("setup", (8, 3, 2, L), 1),
    "node_render": ("gain8", (8, 2, L), 5),
    "render_2d": ("gain4", (8, 4, 2, L), 9),
    "time_render": ("setup", (3, 2, L), 10),
    "grad_2d": ("exact", (8, 4, 2, L), 11),
    "time_grad": ("exact", (4, 2, L), 12),
    "node_grad": ("exact", (4, 2, L), 13),
    "node_buses": ("buses", (12, 2, L), 18),
    "console_node": ("console", (CONSOLE_CHAINS, 2, 4 * L), 19),
    "uneven": ("uneven", (UNEVEN_CHAINS, 2, L), 14),
    "noise_node": ("noise", (4, 2, L), 15),
    "noise_batch": ("noise", (4, 4, 2, L), 16),
    "multihost": ("multihost", (8, 4, 2, MULTIHOST_L), 17),
}
NOISE_KEY = 3


def sharding_of(case, world, mesh, mesh2):
    return {
        "data_render": lambda: parallel.batch_sharding(mesh),
        "data_grad": lambda: parallel.batch_sharding(mesh),
        "node_render": lambda: parallel.node_sharding(mesh),
        "render_2d": lambda: parallel.batch_node_sharding(mesh2),
        "time_render": lambda: parallel.time_sharding(mesh, ndim=3),
        "grad_2d": lambda: parallel.batch_node_sharding(mesh2),
        "time_grad": lambda: parallel.time_sharding(mesh, ndim=3),
        "node_grad": lambda: parallel.node_sharding(mesh),
        "node_buses": lambda: parallel.node_sharding(mesh),
        "console_node": lambda: parallel.node_sharding(mesh),
        "uneven": lambda: parallel.node_sharding(mesh),
        "noise_node": lambda: parallel.node_sharding(mesh),
        "noise_batch": lambda: parallel.batch_sharding(mesh),
        "multihost": lambda: parallel.batch_sharding(mesh),
    }[case]()


# ---------------------------------------------------------------------------
# What a rank and the parent compute
# ---------------------------------------------------------------------------


def loss_and_grads(render, params, x, rng=None):
    """``mean(y ** 2)`` of ``render(x, params)[0]`` (the JAX tests' loss;
    ``data_grad``'s target is zeros) plus the intermediates (the
    optimizer's aux losses), and its gradient in every leaf."""
    p = tree_map(lambda v: v.detach().clone().requires_grad_(True), params)
    y, intermediates, _ = render(x, p, rng=rng) if rng is not None else render(x, p)
    aux = sum(v.sum() for inter in intermediates for _, v in tree_items(inter))
    loss = torch.mean(y**2) + aux
    items = tree_items(p)
    grads = torch.autograd.grad(loss, [v for _, v in items], allow_unused=True)
    return y.detach().numpy(), loss.item(), {
        k: (torch.zeros_like(v) if g is None else g).numpy() for (k, v), g in zip(items, grads)}


def sgd_steps(render, params, x):
    """examples/multihost_dp.py's loop: SGD at lr 1e-2 on ``mean(y ** 2)``."""
    p = tree_map(lambda v: v.detach().clone().requires_grad_(True), params)
    opt = torch.optim.SGD([v for _, v in tree_items(p)], lr=MULTIHOST_LR)
    for _ in range(MULTIHOST_STEPS):
        opt.zero_grad()
        loss = torch.mean(render(x, p)[0] ** 2)
        loss.backward()
        opt.step()
    return loss.item(), {k: v.detach().numpy() for k, v in tree_items(p)}


class RowsLog:
    """A processor that logs the rows it is called on."""

    def __init__(self, processor, log):
        self.processor, self.log = processor, log

    def __call__(self, *signals, **kwargs):
        self.log.append(signals[0].shape[0])
        return self.processor(*signals, **kwargs)


def run_case(case, world, inputs, mesh, mesh2):
    """One case on this rank: its sharded render (and gradient) on the
    rank's shard of the input."""
    graph, _, _ = CASES[case]
    procs, plan = port_graph(graph)
    x, params = torch.tensor(inputs["x"][case]), parameters_from_numpy(inputs["params"][graph])
    sharding = sharding_of(case, world, mesh, mesh2)
    local = parallel.local_shard(x, sharding, even=case not in ("uneven", "console_node"))
    out = {}
    if case == "uneven":
        rows = []
        procs = {t: RowsLog(p, rows) for t, p in procs.items()}
        out["rows"] = rows
    sharded = parallel.make_sharded_render_fn(procs, plan, sharding)
    if case in ("data_render", "node_render", "render_2d", "time_render"):
        with torch.no_grad():
            out["y"] = sharded(local, params)[0].numpy()
        if case == "data_render":
            step = parallel.shard_render_step(make_render_fn(procs, plan), mesh)
            with torch.no_grad():
                out["y_step"] = step(local, params)[0].numpy()
        return out
    if case == "multihost":
        render = parallel.shard_render_step(make_render_fn(procs, plan, jit=False), mesh, jit=False)
        out["loss"], out["params"] = sgd_steps(render, params, local)
        return out
    rng = random.PRNGKey(NOISE_KEY) if graph == "noise" else None
    sharded = parallel.make_sharded_render_fn(procs, plan, sharding, jit=False)
    out["y"], out["loss"], out["grads"] = loss_and_grads(sharded, params, local, rng)
    if case == "data_grad":
        step = parallel.shard_render_step(make_render_fn(procs, plan, jit=False), mesh, jit=False)
        _, out["loss_step"], out["grads_step"] = loss_and_grads(step, params, local)
    return out


def refusals():
    """What must raise on a rank: a batch the mesh axis does not divide,
    and a mesh on the card, the default, where there is none (no
    fallback to the CPU)."""
    mesh = parallel.make_mesh(device="cpu")
    k = dist.get_world_size()
    out = {}
    for name, fn in {
        "nondividing_batch": lambda: parallel.local_shard(
            torch.zeros(2 * k + 1, 3, 2, 8), parallel.batch_sharding(mesh)),
        "nondividing_time": lambda: parallel.local_shard(
            torch.zeros(3, 2, 8 * k + 1), parallel.time_sharding(mesh, ndim=3)),
        "mesh_on_the_card": lambda: parallel.make_mesh(),
    }.items():
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def rank_main(rank, world, directory):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        mesh = parallel.make_mesh(device="cpu")
        mesh2 = parallel.make_mesh_2d(world // 2, 2, device="cpu")
        results = {"world": dist.get_world_size(), "mesh": tuple(mesh.shape),
                   "mesh2": tuple(mesh2.shape), "refusals": refusals()}
        for case in CASES:
            results[case] = run_case(case, world, inputs, mesh, mesh2)
        torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Fixtures (the parent)
# ---------------------------------------------------------------------------


def port_graph_params():
    return bench_console(CONSOLE_CHAINS, device="cpu", processors=bench_processors(backend="fsm")).params


def jax_graph(name):
    from grafx_tpu import data as jdata
    from grafx_tpu import processors as jproc
    from grafx_tpu.render import make_render_fn as j_make_render_fn
    from grafx_tpu.render import prepare_render as j_prepare
    from grafx_tpu.render import reorder_for_fast_render as j_reorder

    num, chain, types, make = GRAPHS[name]
    procs = make(jproc)
    G = chains(jdata, num, chain, types)
    plan = j_prepare(j_reorder(jdata.convert_to_tensor(G), method="beam", use_native=False))
    return procs, G, j_make_render_fn(procs, plan, jit=False)


# grafx_tpu's parameter keys of tests/test_parallel.py (setup: the default)
JAX_KEYS = {"setup": 0, "gain8": 0, "gain4": 0, "exact": 3, "multihost": 0}


@pytest.fixture(scope="module")
def inputs():
    """Every case's input (numpy, seeded) and every graph's parameters:
    grafx_tpu's for the graphs of tests/test_parallel.py and
    examples/multihost_dp.py, the port's own for the added ones."""
    import jax

    from grafx_tpu.utils import create_empty_parameters as j_create_params

    out = {"x": {}, "params": {}}
    for case, (_, shape, seed) in CASES.items():
        out["x"][case] = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    for name, key in JAX_KEYS.items():
        procs, G, _ = jax_graph(name)
        out["params"][name] = jax.tree.map(np.asarray, j_create_params(procs, G, key=jax.random.PRNGKey(key)))
    from grafx_tpu_torch.utils import create_empty_parameters

    out["params"]["console"] = tree_map(lambda v: v.numpy(), port_graph_params())
    for name in ("uneven", "noise", "buses"):
        num, chain, types, make = GRAPHS[name]
        params = create_empty_parameters(make(tproc), chains(tdata, num, chain, types, BUSES.get(name)),
                                         std=0.3, generator=torch.Generator().manual_seed(21))
        out["params"][name] = tree_map(lambda v: v.numpy(), params)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"{k}ranks")
def ranks(request, inputs, tmp_path_factory):
    """Every rank's results at one world size."""
    world = request.param
    directory = str(tmp_path_factory.mktemp(f"ranks{world}"))
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    mp.start_processes(rank_main, args=(world, directory), nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def port_refs(inputs):
    """The unsharded port's render (and gradient) of every case."""
    refs = {}
    for case, (graph, _, _) in CASES.items():
        procs, plan = port_graph(graph)
        render = make_render_fn(procs, plan, jit=False)
        x, params = torch.tensor(inputs["x"][case]), parameters_from_numpy(inputs["params"][graph])
        if case == "multihost":
            refs[case] = dict(zip(("loss", "params"), sgd_steps(render, params, x)))
            continue
        rng = random.PRNGKey(NOISE_KEY) if graph == "noise" else None
        y, loss, grads = loss_and_grads(render, params, x, rng)
        refs[case] = {"y": y, "loss": loss, "grads": grads}
        if graph == "noise":
            refs[case]["y_other_key"] = render(x, params, rng=random.PRNGKey(NOISE_KEY + 1))[0] \
                .detach().numpy()
    return refs


@pytest.fixture(scope="module")
def jax_refs(inputs, ranks):
    """grafx_tpu's sharded results of the ported cases on a mesh of as
    many virtual devices as ranks (tests/test_parallel.py's layouts)."""
    import jax
    import jax.numpy as jnp

    from grafx_tpu.parallel import (
        batch_node_sharding,
        batch_sharding,
        make_mesh,
        make_mesh_2d,
        node_sharding,
        replicated,
        time_sharding,
    )

    world = len(ranks)
    mesh, mesh2 = make_mesh(world), make_mesh_2d(world // 2, 2)
    layouts = {
        "data_render": batch_sharding(mesh), "data_grad": batch_sharding(mesh),
        "node_render": node_sharding(mesh), "render_2d": batch_node_sharding(mesh2),
        "time_render": time_sharding(mesh, ndim=3), "grad_2d": batch_node_sharding(mesh2),
        "time_grad": time_sharding(mesh, ndim=3),
    }
    refs = {}
    for case, sharding in layouts.items():
        graph = CASES[case][0]
        _, _, render = jax_graph(graph)
        rep = replicated(mesh2 if sharding.mesh is mesh2 else mesh)
        x = jax.device_put(jnp.asarray(inputs["x"][case]), sharding)
        params = jax.device_put(jax.tree.map(jnp.asarray, inputs["params"][graph]), rep)
        if "render" in case:
            refs[case] = {"y": np.asarray(jax.jit(lambda x, p: render(x, p)[0])(x, params))}
            continue

        def loss(p, x):
            return jnp.mean(render(x, p)[0] ** 2)

        value, grads = jax.jit(jax.value_and_grad(loss))(params, x)
        refs[case] = {"loss": float(value),
                      "grads": dict(tree_items(jax.tree.map(np.asarray, grads))),
                      "replicated": all(g.sharding.is_fully_replicated for g in jax.tree.leaves(grads))}
    return refs


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def cat(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def assert_grads_close(got, ref, **tol):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **(tol or GRAD_TOL))


def assert_grads_near_jax(got, ref):
    """Concatenated gradient <= -60 dB, each leaf whose JAX gradient is
    nonzero <= -40 dB, leaves zero in JAX zero in the port."""
    assert got.keys() == ref.keys()
    assert db(cat(got) - cat(ref), cat(ref)) <= -60.0
    for k in ref:
        if np.any(ref[k] != 0):
            assert db(got[k] - ref[k], ref[k]) <= -40.0, (k, db(got[k] - ref[k], ref[k]))
        else:
            assert np.all(got[k] == 0), k


def every_rank(ranks, case, key):
    """The rank's value of ``key``, which every rank must hold alike."""
    values = [r[case][key] for r in ranks]
    for v in values[1:]:
        if isinstance(v, dict):
            assert all(np.array_equal(v[k], values[0][k]) for k in v), (case, key)
        else:
            assert np.array_equal(v, values[0]), (case, key)
    return values[0]


def test_ranks_available(ranks):
    world = len(ranks)
    for r in ranks:
        assert r["world"] == world
        assert r["mesh"] == (world,) and r["mesh2"] == (world // 2, 2)


@pytest.mark.parametrize("form", ["y", "y_step"])
def test_data_parallel_render_matches_single_device(ranks, port_refs, jax_refs, form):
    """``make_sharded_render_fn(batch_sharding)`` and ``shard_render_step``
    (compiled; eager on the CPU)."""
    y = every_rank(ranks, "data_render", form)
    np.testing.assert_allclose(y, port_refs["data_render"]["y"], **RENDER_TOL)
    ref = jax_refs["data_render"]["y"]
    assert db(y - ref, ref) <= -60.0


@pytest.mark.parametrize("form", ["grads", "grads_step"])
def test_data_parallel_grad_step(ranks, port_refs, jax_refs, form):
    """The loss and gradients on every rank are the single-device ones,
    alike on every rank (replicated, as grafx_tpu's are)."""
    grads = every_rank(ranks, "data_grad", form)
    loss = every_rank(ranks, "data_grad", "loss" if form == "grads" else "loss_step")
    ref = port_refs["data_grad"]
    assert np.isfinite(loss) and all(np.isfinite(g).all() for g in grads.values())
    np.testing.assert_allclose(loss, ref["loss"], rtol=2e-4)
    assert_grads_close(grads, ref["grads"])
    assert jax_refs["data_grad"]["replicated"]
    assert_grads_near_jax(grads, jax_refs["data_grad"]["grads"])


@pytest.mark.parametrize("case", ["node_render", "render_2d", "time_render"])
def test_sharded_render_matches_single_device(ranks, port_refs, jax_refs, case):
    """tests/test_parallel.py's node-, 2-D- and time-sharded renders."""
    y = every_rank(ranks, case, "y")
    np.testing.assert_allclose(y, port_refs[case]["y"], **RENDER_TOL)
    ref = jax_refs[case]["y"]
    assert db(y - ref, ref) <= -60.0


@pytest.mark.parametrize("case", ["grad_2d", "time_grad"])
def test_sharded_grad_matches_single_device(ranks, port_refs, jax_refs, case):
    """tests/test_parallel.py's 2-D and time-sharded gradients through the
    exact IIR and the ballistics compressor."""
    grads = every_rank(ranks, case, "grads")
    assert_grads_close(grads, port_refs[case]["grads"])
    np.testing.assert_allclose(every_rank(ranks, case, "loss"), jax_refs[case]["loss"], rtol=1e-5)
    assert_grads_near_jax(grads, jax_refs[case]["grads"])


def test_console_node_split(ranks, port_refs):
    """bench.py's console (5 chains) on fsm equalizers, fused: its
    FusedFIRChains' precomputed complex spectra, the padded dynamics
    chains' ``_absent`` rows and the reverb split over the ranks (3/2 and
    2/1/1/1 chains): the render and the gradient are the single-device
    ones."""
    np.testing.assert_allclose(every_rank(ranks, "console_node", "y"),
                               port_refs["console_node"]["y"], **RENDER_TOL)
    assert_grads_close(every_rank(ranks, "console_node", "grads"),
                       port_refs["console_node"]["grads"])


def test_node_split_after_a_mix(ranks, port_refs):
    """Buses of 5, 3, 2 and 2 chains: a rank's bus rows read chains that
    other ranks computed, so the gradient of a stage's input rows must
    come from every rank (``_reduce_grad`` before the split, not only on
    the parameters)."""
    np.testing.assert_allclose(every_rank(ranks, "node_buses", "y"), port_refs["node_buses"]["y"],
                               **RENDER_TOL)
    assert_grads_close(every_rank(ranks, "node_buses", "grads"), port_refs["node_buses"]["grads"])


@pytest.mark.parametrize("case", ["data_grad", "node_grad", "time_grad", "grad_2d", "node_buses"])
def test_gradient_counted_once(ranks, port_refs, case):
    """Under the batch, node, time and 2-D shardings the gradient is the
    single-device one, not a multiple of it: the projection of the
    sharded gradient on the unsharded one is 1 (a gradient summed over k
    ranks once too often reads k)."""
    got, ref = cat(every_rank(ranks, case, "grads")), cat(port_refs[case]["grads"])
    assert abs(got @ ref / (ref @ ref) - 1.0) < 1e-4
    assert_grads_close(every_rank(ranks, case, "grads"), port_refs[case]["grads"])


def test_uneven_node_split(ranks, port_refs):
    """17 chains over 2 ranks split 9/8 (over 4, 5/4/4/4): each rank runs
    its share of every stage, the render and the gradient are the
    single-device ones."""
    world = len(ranks)
    for r, result in enumerate(ranks):
        share = parallel.shares(UNEVEN_CHAINS, world)[r]
        assert result["uneven"]["rows"] == [share, share]  # the gain and compressor stages
    np.testing.assert_allclose(every_rank(ranks, "uneven", "y"), port_refs["uneven"]["y"],
                               **RENDER_TOL)
    assert_grads_close(every_rank(ranks, "uneven", "grads"), port_refs["uneven"]["grads"])


@pytest.mark.parametrize("case", ["noise_node", "noise_batch"])
def test_noise_stage_runs_whole(ranks, port_refs, case):
    """A reverb drawing its noise from ``fold_in(rng, stage)`` over the
    stage's rows, in ``GainStagingRegularization`` (a 0-dim sum over the
    rows in the intermediates), runs whole: the sharded render equals the
    single-device render on the same key (which another key changes),
    and the loss with the intermediates and its gradient count them
    once."""
    ref = port_refs[case]
    y = every_rank(ranks, case, "y")
    np.testing.assert_allclose(y, ref["y"], **RENDER_TOL)
    np.testing.assert_allclose(every_rank(ranks, case, "loss"), ref["loss"], rtol=1e-5)
    assert not np.allclose(y, ref["y_other_key"], **RENDER_TOL)
    assert_grads_close(every_rank(ranks, case, "grads"), ref["grads"])


@pytest.mark.parametrize("what", ["nondividing_batch", "nondividing_time"])
def test_nondividing_shard_raises(ranks, what):
    for r in ranks:
        assert r["refusals"][what] is not None and "does not divide" in r["refusals"][what]


def test_mesh_defaults_to_the_card(ranks):
    """``make_mesh()`` asks for the card; without one it raises and does
    not fall back to the CPU."""
    for r in ranks:
        assert r["refusals"]["mesh_on_the_card"] is not None
        assert "no CUDA device" in r["refusals"]["mesh_on_the_card"]


def test_multihost_dp_check(ranks, port_refs):
    """examples/multihost_dp.py's check: three SGD steps (lr 1e-2) on
    ``mean(y ** 2)`` over the ranks against one process."""
    loss, ref = every_rank(ranks, "multihost", "loss"), port_refs["multihost"]
    params = every_rank(ranks, "multihost", "params")
    rel = abs(loss - ref["loss"]) / (abs(ref["loss"]) + 1e-12)
    diff = max(float(np.abs(params[k] - ref["params"][k]).max()) for k in params)
    assert rel < 1e-5 and diff < 1e-5, (rel, diff)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh_2d(1, 1, device="cpu")
