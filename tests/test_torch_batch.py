"""``batch_grafx`` of grafx_tpu_torch against grafx_tpu's: the batched
graph's nodes, edges and graph attributes, its errors, a render end to
end (grafx_tpu's batched render and each graph rendered alone, rtol 1e-5
as ``tests/graph/test_render.py:385``), and ``_multigraph.union_all``
against ``networkx.union_all`` on random DAGs."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import batch_grafx as j_batch_grafx
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import render_grafx as j_render
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu_torch.data import GRAFX, NodeConfigs, batch_grafx, convert_to_tensor
from grafx_tpu_torch.data._multigraph import MultiDiGraph, union_all
from grafx_tpu_torch.processors import StereoGain, TanhDistortion
from grafx_tpu_torch.render import prepare_render, render_grafx, reorder_for_fast_render
from grafx_tpu_torch.utils import parameters_from_numpy

PORT, REF = (GRAFX, NodeConfigs), (JGRAFX, JNodeConfigs)


def chains(mod, seed, num_graphs=3):
    """``num_graphs`` graphs of one config: random serial chains of gains
    and distortions (the first graph of ``seed`` has a mix of two)."""
    rng = np.random.default_rng(seed)
    config = mod[1](["gain", "dist"])
    graphs = []
    for g in range(num_graphs):
        G = mod[0](config=config)
        body = [str(rng.choice(["gain", "dist"])) for _ in range(int(rng.integers(1, 4)))]
        if g == 0:
            ends = [G.add_serial_chain(["in", *body])[1] for _ in range(2)]
            mix = G.add("mix")
            for e in ends:
                G.connect(e, mix)
            G.connect(mix, G.add("out"))
        else:
            G.add_serial_chain(["in", *body, "out"])
        graphs.append(G)
    return graphs


def summary(G):
    attrs = {k: v for k, v in G.graph.items() if k not in ("config", "config_hash")}
    return (list(G.nodes(data=True)), list(G.edges(data=True, keys=True)), attrs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_grafx_matches_reference(seed):
    GB, JB = batch_grafx(chains(PORT, seed)), j_batch_grafx(chains(REF, seed))
    assert summary(GB) == summary(JB)
    assert GB.batch and GB.counter == JB.counter
    assert GB.number_of_edges() == JB.number_of_edges()
    assert GB.config_hash == hash(GB.config)


def test_batch_grafx_errors():
    graphs = chains(PORT, 0)
    with pytest.raises(ValueError, match="already a batched graph"):
        batch_grafx([batch_grafx(graphs)])
    with pytest.raises(ValueError, match="different node configs"):
        batch_grafx([graphs[0], chains(PORT, 0)[1]])
    G = chains(PORT, 1)[0]
    G.remove(1)
    with pytest.raises(ValueError, match="consecutive"):
        batch_grafx([G])
    with pytest.raises(ValueError, match="empty list"):
        batch_grafx([])
    with pytest.raises(ValueError):
        j_batch_grafx([])


def test_batch_grafx_render_end_to_end():
    """The batched graph renders every graph at once: equal to grafx_tpu's
    batched render on the same numpy parameters, and to each graph
    rendered alone with its rows."""
    config = NodeConfigs(["gain"])
    graphs = [GRAFX(config=config) for _ in range(3)]
    jconfig = JNodeConfigs(["gain"])
    jgraphs = [JGRAFX(config=jconfig) for _ in range(3)]
    for G in graphs + jgraphs:
        G.add_serial_chain(["in", "gain", "out"])
    GB, JB = batch_grafx(graphs), j_batch_grafx(jgraphs)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(GB), method="beam"))
    jplan = j_prepare(j_reorder(j_convert(JB), method="beam"))
    rng = np.random.default_rng(2)
    params = {"gain": {"log_gain": (0.3 * rng.standard_normal((3, 2))).astype(np.float32)}}
    x = rng.standard_normal((3, 2, 2**9)).astype(np.float32)
    out = render_grafx({"gain": StereoGain()}, torch.tensor(x), parameters_from_numpy(params), plan)[0]
    jout = j_render({"gain": jp.StereoGain()}, jnp.asarray(x), jax.tree.map(jnp.asarray, params), jplan)[0]
    assert out.shape == (3, 2, 2**9)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5)
    for g in range(3):
        plan_g = prepare_render(reorder_for_fast_render(convert_to_tensor(graphs[g]), method="beam"))
        p_g = {"gain": {"log_gain": torch.tensor(params["gain"]["log_gain"][g:g + 1])}}
        out_g = render_grafx({"gain": StereoGain()}, torch.tensor(x[g:g + 1]), p_g, plan_g)[0]
        np.testing.assert_allclose(out[g].numpy(), out_g[0].numpy(), rtol=1e-5)


@pytest.mark.parametrize("method", ["beam", "one-by-one"])
def test_batched_random_chains_match_reference(method):
    """Batched random chains of gains and distortions (one graph with a
    mix) under the beam and the one-by-one schedules, against grafx_tpu."""
    GB, JB = batch_grafx(chains(PORT, 4)), j_batch_grafx(chains(REF, 4))
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(GB), method=method))
    jplan = j_prepare(j_reorder(j_convert(JB), method=method))
    types = [d["node_type"] for _, d in GB.nodes(data=True)]
    procs = {"gain": StereoGain(), "dist": TanhDistortion()}
    rng = np.random.default_rng(6)
    params = {t: {k: (0.3 * rng.standard_normal((types.count(t), n))).astype(np.float32)
                  for k, n in p.parameter_size().items()} for t, p in procs.items()}
    x = rng.standard_normal((types.count("in"), 2, 2**9)).astype(np.float32)
    out = render_grafx(procs, torch.tensor(x), parameters_from_numpy(params), plan)[0]
    jout = j_render({"gain": jp.StereoGain(), "dist": jp.TanhDistortion()}, jnp.asarray(x),
                    jax.tree.map(jnp.asarray, params), jplan)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


def random_multidigraph(seed, offset, cls):
    """A random DAG with parallel edges, attributes on nodes, edges and
    the graph, node ids offset by ``offset``."""
    rng = np.random.default_rng(seed)
    G = cls()
    n = int(rng.integers(3, 12))
    G.graph.update(name=f"g{seed}", seed=seed)
    for v in rng.permutation(n):
        G.add_node(int(v) + offset, weight=float(rng.random()))
    for _ in range(int(rng.integers(n, 3 * n))):
        u, v = sorted(rng.choice(n, 2, replace=False))
        G.add_edge(int(u) + offset, int(v) + offset, outlet=str(rng.integers(2)))
    return G


@pytest.mark.parametrize("seed", range(6))
def test_union_all_matches_networkx(seed):
    mine = [random_multidigraph(seed + 10 * i, 100 * i, MultiDiGraph) for i in range(3)]
    ref = nx.union_all([random_multidigraph(seed + 10 * i, 100 * i, nx.MultiDiGraph) for i in range(3)])
    got = union_all(mine)
    assert list(got.nodes(data=True)) == list(ref.nodes(data=True))
    assert list(got.edges(data=True, keys=True)) == list(ref.edges(data=True, keys=True))
    assert got.graph == ref.graph
    with pytest.raises(ValueError, match="not disjoint"):
        union_all([mine[0], mine[0]])
