"""grafx_tpu_torch host layer against grafx_tpu: graphs, schedules, render
plans, fusion and parameter migration on the bench.py console."""

import dataclasses

import jax
import numpy as np
import pytest

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models.console import bench_console, bench_processors
from grafx_tpu_torch.render import fuse_parameters, fuse_serial_lti, prepare_render
from grafx_tpu_torch.render import reorder_for_fast_render
from grafx_tpu_torch.utils import parameters_from_numpy


def jax_processors():
    """bench.py's processors (bench.py:122-130)."""
    return {
        "eq": jp.ParametricEqualizer(num_filters=6, backend="exact"),
        "geq": jp.GraphicEqualizer(scale="bark", backend="exact"),
        "compressor": jp.Compressor(energy_smoother="ballistics"),
        "noisegate": jp.NoiseGate(energy_smoother="iir_exact"),
        "gain": jp.StereoGain(),
        "dist": jp.TanhDistortion(),
        "reverb": jp.STFTMaskedNoiseReverb(ir_len=30000),
    }


FUSE = dict(kinds=("fir", "iir", "dynamics"), dynamics_pad="auto")


def jax_graph(num_chains, monkeypatch):
    monkeypatch.setattr(bench, "NUM_CHAINS", num_chains)
    return bench.build_mix_graph()


def graph_summary(G):
    nodes = [(n, d["node_type"]) for n, d in G.nodes(data=True)]
    edges = [(u, v, d["outlet"], d["inlet"]) for u, v, d in G.edges(data=True)]
    return nodes, edges


@pytest.mark.parametrize("num_chains", [17, 6])
def test_bench_console_graph_matches_bench(num_chains, monkeypatch):
    c = bench_console(num_chains, device="cpu")
    assert graph_summary(c.graph) == graph_summary(jax_graph(num_chains, monkeypatch))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("num_chains", [17, 6])
def test_render_data_matches(num_chains, fused, monkeypatch):
    Gj = jax_graph(num_chains, monkeypatch)
    G = bench_console(num_chains, device="cpu").graph
    if fused:
        Gj, _ = j_fuse(Gj, jax_processors(), **FUSE)
        G, _ = fuse_serial_lti(G, bench_processors(), **FUSE)
        assert graph_summary(G) == graph_summary(Gj)
        assert G.graph["fused_from"] == Gj.graph["fused_from"]
    Gt_j = j_reorder(j_convert(Gj), method="beam", use_native=False)
    Gt = reorder_for_fast_render(convert_to_tensor(G), method="beam")
    for field in ("node_types", "edge_indices", "rendering_orders"):
        np.testing.assert_array_equal(getattr(Gt, field), getattr(Gt_j, field))
    assert Gt.type_sequence == Gt_j.type_sequence
    assert dataclasses.asdict(prepare_render(Gt)) == dataclasses.asdict(j_prepare(Gt_j))


@pytest.mark.parametrize("num_chains", [17, 6])
def test_fuse_parameters_maps_rows_identically(num_chains, monkeypatch):
    Gj = jax_graph(num_chains, monkeypatch)
    procs_j = jax_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(3))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    ref = jax.tree.map(
        np.asarray, j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    )

    c = bench_console(num_chains, device="cpu")
    params = parameters_from_numpy(jax.tree.map(np.asarray, params_j))
    got = fuse_parameters(params, c.graph, c.fused_graph, c.fused_processors)
    got = jax.tree.map(lambda t: t.numpy(), got)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    jax.tree.map(np.testing.assert_array_equal, got, ref)
    # trap: every gate-less chain's padded gate is absent, the rest present
    absent = got["fused(noisegate+compressor)"]["_absent"]
    assert absent[:, 0].sum() == num_chains - len(range(0, num_chains, 3))
    assert absent[:, 1].sum() == 0


def _edit_both(G, ops):
    for op, *args in ops:
        getattr(G, op)(*args)
    return G


@pytest.mark.parametrize(
    "ops",
    [
        [("remove", 2)],
        [("remove", 0), ("remove", 5)],
        [("remove", 3), ("connect", 1, 4)],
    ],
)
def test_multigraph_matches_networkx(ops):
    """The in-package multigraph agrees with the networkx-based GRAFX
    through edits, non-consecutive ids and conversion."""
    def build(GR, NC):
        G = GR(config=NC(["eq", "gain"]))
        G.add_serial_chain(["in", "eq", "gain", "eq", "out"])
        G.add_serial_chain(["in", "gain"])
        G.connect(6, 4)
        return _edit_both(G, ops)

    G, Gj = build(GRAFX, NodeConfigs), build(JGRAFX, JNodeConfigs)
    assert graph_summary(G) == graph_summary(Gj)
    for n in Gj.nodes:
        assert list(G.predecessors(n)) == list(Gj.predecessors(n))
        assert list(G.successors(n)) == list(Gj.successors(n))
        assert G.in_degree(n) == Gj.in_degree(n)
        assert G.out_degree(n) == Gj.out_degree(n)
        assert G.in_edges(n, data=True) == list(Gj.in_edges(n, data=True))
    assert G.number_of_edges() == Gj.number_of_edges()
    assert str(G) == str(Gj)
    Gt, Gt_j = convert_to_tensor(G), j_convert(Gj)
    np.testing.assert_array_equal(Gt.node_types, Gt_j.node_types)
    np.testing.assert_array_equal(Gt.edge_indices, Gt_j.edge_indices)
