"""``grafx_tpu_torch.draw`` against ``grafx_tpu.draw``: node positions
equal on the bench.py console and on random DAGs, figures drawn into
``tmp_path``, the color handler; and ``_multigraph.topological_sort``
equal to ``networkx.topological_sort`` (the positions depend on its
order).  Mirrors ``tests/graph/test_draw.py``."""

import matplotlib

matplotlib.use("Agg")

import networkx as nx
import numpy as np
import pytest

import bench
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.draw import compute_node_position as j_compute_node_position
from grafx_tpu.draw import compute_rank as j_compute_rank
from grafx_tpu.draw import cubic_bezier as j_cubic_bezier
from grafx_tpu_torch.data import GRAFX, NodeConfigs
from grafx_tpu_torch.data._multigraph import MultiDiGraph, topological_sort
from grafx_tpu_torch.draw import (
    NodeColorHandler,
    compute_node_position,
    compute_rank,
    cubic_bezier,
    draw_grafx,
    estimate_chain,
)
from grafx_tpu_torch.models.console import bench_graph

PORT, REF = (GRAFX, NodeConfigs), (JGRAFX, JNodeConfigs)


def mix_graph(mod=PORT):
    G = mod[0](config=mod[1](["eq", "comp", "reverb"]))
    ends = [G.add_serial_chain(chain)[1]
            for chain in (["in", "eq", "comp"], ["in", "eq"], ["in", "reverb"])]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


def random_console(mod, seed):
    """Chains into two mixes (some chains feed both) and a bus chain."""
    rng = np.random.default_rng(seed)
    G = mod[0](config=mod[1](["eq", "comp", "reverb"]))
    ends = [G.add_serial_chain(["in"] + [str(rng.choice(["eq", "comp", "reverb"]))
                                         for _ in range(int(rng.integers(1, 4)))])[1]
            for _ in range(int(rng.integers(2, 7)))]
    mixes = [G.add("mix") for _ in range(2)]
    for e in ends:
        G.connect(e, mixes[0])
        if rng.random() < 0.4:
            G.connect(e, mixes[1])
    first, last = G.add_serial_chain(["eq", "comp"])
    G.connect(mixes[0], first)
    G.connect(last, mixes[1])
    G.connect(mixes[1], G.add("out"))
    return G


def positions(G):
    return [(n, d["x0"], d["y0"], d["rank"], d["chain"], d["level"]) for n, d in G.nodes(data=True)]


@pytest.mark.parametrize("seed", range(6))
def test_positions_match_reference(seed):
    G, J = random_console(PORT, seed), random_console(REF, seed)
    compute_node_position(G)
    j_compute_node_position(J)
    assert positions(G) == positions(J)


def test_console_positions_match_reference(monkeypatch):
    monkeypatch.setattr(bench, "NUM_CHAINS", 17)
    G, J = bench_graph(17), bench.build_mix_graph()
    compute_node_position(G, node_spacing=(1.0, 0.5))
    j_compute_node_position(J, node_spacing=(1.0, 0.5))
    assert positions(G) == positions(J)
    G_sorted, ranks, chains = compute_rank(bench_graph(17))
    j_sorted, j_ranks, j_chains = j_compute_rank(bench.build_mix_graph())
    assert (G_sorted, ranks, chains) == (j_sorted, j_ranks, j_chains)
    assert chains == estimate_chain(bench_graph(17))


def random_dag(seed, cls):
    """A DAG with parallel edges, its nodes inserted in a random order."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 30))
    G = cls()
    for v in rng.permutation(n):
        G.add_node(int(v))
    for _ in range(int(rng.integers(0, 3 * n))):
        u, v = sorted(rng.choice(n, 2, replace=False))
        G.add_edge(int(u), int(v))
    return G


@pytest.mark.parametrize("seed", range(8))
def test_topological_sort_matches_networkx(seed):
    assert topological_sort(random_dag(seed, MultiDiGraph)) == list(
        nx.topological_sort(random_dag(seed, nx.MultiDiGraph)))


def test_topological_sort_refuses_cycle():
    G = MultiDiGraph()
    G.add_edge(0, 1)
    G.add_edge(1, 2)
    G.add_edge(2, 1)
    with pytest.raises(ValueError, match="cycle"):
        topological_sort(G)


def test_draw_smoke(tmp_path):
    fig, ax = draw_grafx(mix_graph())
    fig.savefig(tmp_path / "graph.pdf")
    assert (tmp_path / "graph.pdf").stat().st_size > 0


def test_draw_vertical_and_labels(tmp_path):
    G = mix_graph()
    fig, _ = draw_grafx(G, vertical=True, node_inside="node_id", node_above="node_type")
    fig.savefig(tmp_path / "graph_v.png")
    assert "x0" not in G.nodes[0]  # drawn on a copy
    with pytest.raises(ValueError, match="Wrong prefix"):
        draw_grafx(G, color_x=1)


def test_draw_console(tmp_path):
    fig, ax = draw_grafx(bench_graph(17), colors={"eq": "#123456", "geq": "#654321", "compressor": "c",
                                                   "noisegate": "m", "gain": "y", "dist": "k", "reverb": "w",
                                                   "mix": "#eeeeee"})
    fig.savefig(tmp_path / "console.png")
    assert fig.get_size_inches()[0] > 0


def test_positions_causal():
    G = mix_graph()
    compute_node_position(G)
    for s, t in G.edges():
        assert G.nodes[s]["x0"] < G.nodes[t]["x0"]


def test_cubic_bezier_matches_reference():
    P = np.random.default_rng(0).standard_normal((4, 2))
    t = np.linspace(0, 1, 11)
    np.testing.assert_allclose(cubic_bezier(t, P), j_cubic_bezier(t, P))
    np.testing.assert_allclose(cubic_bezier(t, P)[[0, -1]], P[[0, 3]])


def test_color_handler():
    h = NodeColorHandler(node_types=["in", "out", "mix", "eq", "comp"])
    assert h.get_facecolor("in") == "w"
    assert h.get_edgecolor("in") == "b"
    assert h.get_edgecolor("out") == "r"
    assert h.get_facecolor("eq") != h.get_facecolor("comp")
    custom = NodeColorHandler(facecolor_map={"eq": "#123456"})
    assert custom.get_colors("eq")["facecolor"] == "#123456"
