"""FIR-LTI fusion and the containers: FusedFIRChain against the unfused
render (to float round-off for causal members; for zero-phase members
against the per-node render of the start-padded signal, the fused
semantics) and against grafx_tpu's fused render, fuse_parameters' FIR
nesting, the streams of the fused chain and of the containers, and
GraphParameterOptimizer(fuse=True) on the gain -> delay console."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import GraphParameterOptimizer, mixing_console
from grafx_tpu_torch.render import (
    FusedFIRChain,
    StreamRenderer,
    fuse_parameters,
    fuse_serial_fir,
    fuse_serial_lti,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map

# rel. to max|ref|: a fused render against the unfused one
# (tests/graph/test_fuse.py:288), and the port's fused render against
# grafx_tpu's (the composed IR carries each member's round-off); a single
# processor against grafx_tpu's
FUSED_REL = 3e-5
JAX_REL = 1e-5
L = 2**13
PAD = 4608  # >= the longest IR + the zero-phase lookahead


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def random_params(sizes, rows, rng, std=0.3):
    out = {}
    for k, v in sizes.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rows, rng, std)
        else:
            shape = (rows,) + (v if isinstance(v, tuple) else (v,))
            out[k] = (std * rng.standard_normal(shape)).astype(np.float32)
    return out


def chains(make):
    """``(name, processors of module make, chain)`` cases: causal runs,
    zero-phase members, containers, fsm cascades."""
    m = make
    return {
        "fsm eq+geq+lp": (lambda: {
            "peq": m.ParametricEqualizer(num_filters=4),
            "geq": m.GraphicEqualizer(scale="bark"),
            "lp": m.LowPassFilter(),
        }, ["peq", "geq", "lp"]),
        "gain+delay": (lambda: {
            "gain": m.StereoGain(),
            "delay": m.MultitapDelay(segment_len=300, num_segments=3),
        }, ["gain", "delay"]),
        "zpeq+reverb": (lambda: {
            "zpeq": m.NewZeroPhaseFIREqualizer(num_frequency_bins=256),
            "reverb": m.STFTMaskedNoiseReverb(ir_len=4000),
        }, ["zpeq", "reverb"]),
        "drywet+fir": (lambda: {
            "dw": m.DryWet(m.NewZeroPhaseFIREqualizer(num_frequency_bins=128), external_param=False),
            "fir": m.FIRFilter(fir_len=127, processor_channel="stereo"),
        }, ["dw", "fir"]),
        "parallel+gain": (lambda: {
            "pm": m.ParallelMix({
                "zp": m.NewZeroPhaseFIREqualizer(num_frequency_bins=128),
                "dl": m.MultitapDelay(segment_len=200, num_segments=2),
            }),
            "gain": m.StereoGain(),
        }, ["pm", "gain"]),
        "serial+bpf": (lambda: {
            "sc": m.SerialChain({"pk": m.PeakingFilter(num_filters=2), "g": m.StereoGain()}),
            "bpf": m.BandPassFilter(),
        }, ["sc", "bpf"]),
    }


CASES = list(chains(tp))
CAUSAL = {"fsm eq+geq+lp", "gain+delay", "serial+bpf"}


def build(module_graph, procs, chain, num=2):
    G = module_graph[0](config=module_graph[1](sorted(procs)))
    ends = [G.add_serial_chain(["in"] + chain)[1] for _ in range(num)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


def port_render(G, procs, params, x):
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    with torch.no_grad():
        out, inter, _ = make_render_fn(procs, plan, jit=False)(torch.tensor(x), params)
    return out.numpy(), inter


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """One chain in two copies (a node batch of 2) summed to the output,
    rendered by the port unfused (also on the start-padded signal) and
    fused, and by grafx_tpu fused, from the same numpy parameters."""
    name = request.param
    make_t, chain = chains(tp)[name]
    make_j, _ = chains(jp)[name]
    procs, procs_j = make_t(), make_j()
    G, Gj = build((GRAFX, NodeConfigs), procs, chain), build((JGRAFX, JNodeConfigs), procs_j, chain)
    rng = np.random.default_rng(len(name))
    params_np = {t: random_params(procs[t].parameter_size(), 2, rng) for t in chain}
    params = parameters_from_numpy(params_np)
    x = rng.standard_normal((2, 2, L)).astype(np.float32)

    G2, procs2 = fuse_serial_lti(G, procs)
    params2 = fuse_parameters(params, G, G2, procs2)
    y_fused, inter = port_render(G2, procs2, params2, x)
    y, inter_unfused = port_render(G, procs, params, x)
    y_padded = port_render(G, procs, params, np.pad(x, ((0, 0), (0, 0), (PAD, 0))))[0][..., PAD:]

    Gj2, procs_j2 = j_fuse(Gj, procs_j)
    params_j2 = j_fuse_parameters(jax.tree.map(jnp.asarray, params_np), Gj, Gj2, procs_j2,
                                  use_native=False)
    plan_j = j_prepare(j_reorder(j_convert(Gj2), method="beam", use_native=False))
    y_j = np.asarray(j_make_render_fn(procs_j2, plan_j)(jnp.asarray(x), params_j2)[0])
    return dict(name=name, chain=chain, G=G, G2=G2, Gj2=Gj2, procs=procs, procs2=procs2,
                params=params, params2=params2, params_j2=params_j2, x=x, y=y, y_fused=y_fused,
                y_padded=y_padded, y_j=y_j, inter=inter, inter_unfused=inter_unfused)


def test_fir_run_folds_into_fused_fir_chain(case):
    fused = [t for t in case["procs2"] if t.startswith("fused(")]
    assert fused == ["fused(" + "+".join(case["chain"]) + ")"]
    assert isinstance(case["procs2"][fused[0]], FusedFIRChain)
    assert case["G2"].number_of_nodes() == case["G"].number_of_nodes() - 2 * (len(case["chain"]) - 1)
    assert case["G2"].graph["fused_from"] == case["Gj2"].graph["fused_from"]


def test_fused_render_matches_unfused(case):
    """Causal chains equal the unfused render; chains with zero-phase
    members equal the unfused render of the start-padded signal."""
    ref = case["y"] if case["name"] in CAUSAL else case["y_padded"]
    assert max_rel(case["y_fused"], ref) <= FUSED_REL, max_rel(case["y_fused"], ref)


def test_fused_render_matches_grafx_tpu(case):
    assert max_rel(case["y_fused"], case["y_j"]) <= FUSED_REL, max_rel(case["y_fused"], case["y_j"])


def test_fuse_parameters_nests_fir_members_like_grafx_tpu(case):
    got = dict(tree_items(case["params2"]))
    want = dict(tree_items(jax.tree.map(np.asarray, case["params_j2"])))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_fused_aux_losses_survive(case):
    """A delay member's radii_reg flows out of the fused chain."""
    leaves = lambda inter: sorted(  # noqa: E731
        float(v.sum()) for i in inter for _, v in tree_items(i)
    )
    np.testing.assert_allclose(leaves(case["inter"]), leaves(case["inter_unfused"]), rtol=1e-6)
    if "delay" in case["name"] or "parallel" in case["name"]:
        assert case["inter"]


def test_fused_chain_streams_or_refuses(case):
    """A causal fused chain streams in blocks of 1024 like its one-shot
    render; one with zero-phase lookahead refuses, as in grafx_tpu."""
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(case["G2"]), method="beam"))
    if case["name"] not in CAUSAL:
        with pytest.raises(NotImplementedError, match="lookahead|zero-phase"):
            StreamRenderer(case["procs2"], plan, case["params2"], block_len=1024)
        return
    streamer = StreamRenderer(case["procs2"], plan, case["params2"], block_len=1024)
    state, blocks = streamer.init_state(), []
    for xb in torch.tensor(case["x"]).split(1024, dim=-1):
        yb, state = streamer(xb, state)
        blocks.append(yb)
    got = torch.cat(blocks, dim=-1).numpy()
    assert max_rel(got, case["y_fused"]) <= FUSED_REL


@pytest.mark.parametrize("chain", [["gain", "delay"], ["gain", "gain2", "delay"], ["gain", "gain2"]])
def test_leading_gains_render_as_the_unfused_nodes(chain):
    """A fused run's leading one-tap members scale the input, as the
    unfused nodes do, so a run of gains, or of gains then a delay,
    renders as its nodes, to the bit; and streams as they do, to the bit,
    in blocks of 1024."""
    makers = {"gain": tp.StereoGain, "gain2": tp.StereoGain,
              "delay": lambda: tp.MultitapDelay(segment_len=300, num_segments=3)}
    procs = {t: makers[t]() for t in chain}
    G = build((GRAFX, NodeConfigs), procs, chain)
    rng = np.random.default_rng(7)
    params = parameters_from_numpy({t: random_params(procs[t].parameter_size(), 2, rng) for t in chain})
    x = rng.standard_normal((2, 2, L)).astype(np.float32)
    G2, procs2 = fuse_serial_lti(G, procs)
    assert [t for t in procs2 if t.startswith("fused(")] == ["fused(" + "+".join(chain) + ")"]
    params2 = fuse_parameters(params, G, G2, procs2)
    y_fused = port_render(G2, procs2, params2, x)[0]
    np.testing.assert_array_equal(y_fused, port_render(G, procs, params, x)[0])
    streamed = []
    for graph, ps, pa in ((G2, procs2, params2), (G, procs, params)):
        plan = prepare_render(reorder_for_fast_render(convert_to_tensor(graph), method="beam"))
        streamer = StreamRenderer(ps, plan, pa, block_len=1024)
        state, out = streamer.init_state(), []
        for xb in torch.tensor(x).split(1024, dim=-1):
            yb, state = streamer(xb, state)
            out.append(yb)
        streamed.append(torch.cat(out, dim=-1).numpy())
    np.testing.assert_array_equal(*streamed)


def test_fuse_serial_fir_is_the_fir_slice():
    procs = {"gain": tp.StereoGain(), "lp": tp.LowPassFilter(backend="exact"),
             "hp": tp.HighPassFilter(backend="exact"), "dl": tp.MultitapDelay(300, 2)}
    G = build((GRAFX, NodeConfigs), procs, ["gain", "dl", "lp", "hp"], num=1)
    G2, procs2 = fuse_serial_fir(G, procs)
    assert sorted(t for t in procs2 if t.startswith("fused(")) == ["fused(gain+dl)"]
    G3, procs3 = fuse_serial_lti(G, procs)
    assert sorted(t for t in procs3 if t.startswith("fused(")) == ["fused(gain+dl)", "fused(lp+hp)"]


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.DryWet(m.LowPassFilter(backend="exact"), external_param=False),
        lambda m: m.SerialChain({"pk": m.PeakingFilter(num_filters=2), "dist": m.TanhDistortion()}),
        lambda m: m.ParallelMix({"lp": m.LowPassFilter(), "g": m.StereoGain()}, activation="softplus"),
        lambda m: m.GainStagingRegularization(m.MultitapDelay(segment_len=200, num_segments=2)),
    ],
    ids=["DryWet", "SerialChain", "ParallelMix", "GainStagingRegularization"],
)
def test_container_matches_grafx_tpu_and_streams(make):
    """Each container's output and aux losses against grafx_tpu's, its
    stream against its one-shot output, and its output on a noise_key
    against grafx_tpu's on the same key."""
    jproc, tproc = make(jp), make(tp)
    assert jproc.parameter_size() == tproc.parameter_size()
    rng = np.random.default_rng(4)
    p = random_params(tproc.parameter_size(), 2, rng)
    x = rng.standard_normal((2, 2, 2**12)).astype(np.float32)
    out_j = jproc(jnp.asarray(x), **jax.tree.map(jnp.asarray, p))
    out = tproc(torch.tensor(x), **parameters_from_numpy(p))
    (y_j, aux_j), (y, aux) = (o if isinstance(o, tuple) else (o, None) for o in (out_j, out))
    assert max_rel(y.detach().numpy(), np.asarray(y_j)) <= JAX_REL
    got_aux = dict(tree_items(aux or {}))
    want_aux = dict(tree_items(jax.tree.map(np.asarray, aux_j or {})))
    assert got_aux.keys() == want_aux.keys()
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].detach().numpy(), want_aux[k], rtol=1e-4, err_msg=k)

    with torch.no_grad():
        state, cache = tproc.stream_init(2, 1024, **parameters_from_numpy(p))
        blocks = []
        for xb in torch.tensor(x).split(1024, dim=-1):
            yb, state = tproc.stream_step(xb, state, cache)
            blocks.append(yb)
    assert max_rel(torch.cat(blocks, dim=-1).numpy(), y.detach().numpy()) <= FUSED_REL
    # a noise_key (once refused, before RNG threading) passes through to
    # the members that take one, as in grafx_tpu: equal on the same key
    from grafx_tpu_torch import random as tr

    jkey = jax.random.PRNGKey(5)
    out_j = jproc(jnp.asarray(x), **jax.tree.map(jnp.asarray, p), noise_key=jkey)
    out = tproc(torch.tensor(x), **parameters_from_numpy(p),
                noise_key=tr.key_from_numpy(np.asarray(jkey)))
    (y_j, _), (y, _) = (o if isinstance(o, tuple) else (o, None) for o in (out_j, out))
    assert max_rel(y.detach().numpy(), np.asarray(y_j)) <= JAX_REL


@pytest.mark.parametrize("backend", ["exact", "fsm"])
def test_optimizer_fuses_the_gain_delay_console(backend):
    """GraphParameterOptimizer(fuse=True) takes the fit console with a
    delay after each track's gain: gain -> delay folds into FusedFIRChain
    on every track, and with the same generator the fused optimizer's
    render, loss and gradient equal the unfused one's."""
    stems = torch.tensor(np.random.default_rng(0).standard_normal((3, 2, L)).astype(np.float32))
    target = torch.tensor(np.random.default_rng(1).standard_normal((1, 2, L)).astype(np.float32))
    runs = {}
    for fuse in (False, True):
        G, procs = mixing_console(3, track_chain=("eq", "compressor", "gain", "delay"),
                                  backend=backend, ir_len=2000)
        opt = GraphParameterOptimizer(G, procs, generator=torch.Generator().manual_seed(1),
                                      device="cpu", fuse=fuse)
        total, audio = opt.loss(stems, target)
        total.backward()
        grad_sq = sum(float((p.grad**2).sum()) for _, p in tree_items(opt.params) if p.grad is not None)
        runs[fuse] = dict(opt=opt, y=opt.render_current(stems).numpy(), total=total.item(),
                          audio=audio.item(), grad_sq=grad_sq)
    fused = runs[True]["opt"]
    assert sorted(t for t in fused.processors if t.startswith("fused(")) == ["fused(gain+delay)"]
    assert sum(fused.G.nodes[n]["node_type"] == "fused(gain+delay)" for n in fused.G.nodes) == 3
    assert max_rel(runs[True]["y"], runs[False]["y"]) <= FUSED_REL
    for k in ("total", "audio", "grad_sq"):
        np.testing.assert_allclose(runs[True][k], runs[False][k], rtol=1e-4, err_msg=k)
    # the fused parameters are the unfused ones, migrated row by row
    unfused = runs[False]["opt"].params
    nested = fused.params["fused(gain+delay)"]
    for member, t in (("0_gain", "gain"), ("1_delay", "delay")):
        for k, v in nested[member].items():
            assert sorted(map(tuple, v.detach().numpy().reshape(3, -1).tolist())) == sorted(
                map(tuple, unfused[t][k].detach().numpy().reshape(3, -1).tolist()))
