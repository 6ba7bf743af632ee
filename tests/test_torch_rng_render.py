"""RNG threading and common_parameters through the executor: the ports of
tests/graph/test_render.py's common_parameters (DryWet), rng and
rng-through-containers tests, each held against grafx_tpu's render on the
same numpy inputs, parameters and key; FusedFIRChain on a key; streamed
renders with rng and with common_parameters; the two-outlet and two-inlet
stereo tools through the executor and the streamer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import FusedFIRChain as JFusedFIRChain
from grafx_tpu.render import StreamRenderer as JStreamRenderer
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch import random as tr
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.render import (
    FusedFIRChain,
    StreamRenderer,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
    render_grafx,
)
from grafx_tpu_torch.utils import create_empty_parameters, parameters_from_numpy, tree_map

L = 2**12
BLOCK = 1024
REL = 1e-5  # rel. to max|ref|: the port's render against grafx_tpu's on one key
STREAM_REL = 1e-5  # a streamed render against the one-shot render
GRAD_REL = 1e-4  # a gradient leaf against jax.grad's, rel. to its max


def max_rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def plans(build, procs_t, procs_j, method="greedy"):
    """The same graph built in both packages, its plans, and numpy
    parameters of the port's shapes (std 0.5, seed 0)."""
    G_t, G_j = build(GRAFX, NodeConfigs), build(JGRAFX, JNodeConfigs)
    plan_t = prepare_render(reorder_for_fast_render(convert_to_tensor(G_t), method=method))
    plan_j = j_prepare(j_reorder(j_convert(G_j), method=method))
    rng = np.random.default_rng(0)
    p = tree_map(lambda v: (0.5 * rng.standard_normal(v.shape)).astype(np.float32),
                 create_empty_parameters(procs_t, G_t))
    return G_t, plan_t, plan_j, p


def jkeys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tr.key_from_numpy(np.asarray(jkey))


def chain(types):
    def build(GRAFX, NodeConfigs):
        G = GRAFX(config=NodeConfigs(sorted(set(types))))
        G.add_serial_chain(["in", *types, "out"])
        return G
    return build


@pytest.mark.parametrize("batched", [False, True], ids=["3d", "4d"])
def test_common_parameters_drywet(batched):
    """DryWet with an external weight: one shared drywet tensor indexed by
    node id through common_parameters, against grafx_tpu's render; fully
    dry is the input, fully wet two tanh stages."""
    procs_t = {"dist": tp.DryWet(tp.TanhDistortion(), external_param=True)}
    procs_j = {"dist": jp.DryWet(jp.TanhDistortion(), external_param=True)}
    G, plan_t, plan_j, p = plans(chain(["dist", "dist"]), procs_t, procs_j)
    shape = (2, 1, 2, 256) if batched else (1, 2, 256)
    x = 2.0 * np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    num_nodes = G.number_of_nodes()
    weights = np.random.default_rng(2).standard_normal((num_nodes, 1)).astype(np.float32)
    for w in (weights, np.full((num_nodes, 1), -20.0, np.float32),
              np.full((num_nodes, 1), 20.0, np.float32)):
        ref, _, _ = j_make_render_fn(procs_j, plan_j)(
            jnp.asarray(x), jax.tree.map(jnp.asarray, p), {"drywet_weight": jnp.asarray(w)}
        )
        got, _, _ = render_grafx(procs_t, torch.tensor(x), parameters_from_numpy(p), plan_t,
                                 common_parameters={"drywet_weight": torch.tensor(w)})
        assert max_rel(got.numpy(), ref) <= REL, max_rel(got.numpy(), ref)
    np.testing.assert_allclose(
        render_grafx(procs_t, torch.tensor(x), parameters_from_numpy(p), plan_t,
                     common_parameters={"drywet_weight": torch.full((num_nodes, 1), -20.0)})[0],
        x, atol=1e-4,
    )
    assert float(got.abs().max()) < 1.5  # fully wet: tanh-compressed


@pytest.mark.parametrize("bare", [False, True], ids=["dict", "tensor"])
def test_stream_with_common_parameters_matches_its_render(bare):
    """StreamRenderer(common_parameters=...) against the one-shot render
    with the same common parameters; a bare tensor is a DryWet's
    drywet_weight, as in grafx_tpu's streamer."""
    procs = {"dist": tp.DryWet(tp.TanhDistortion(), external_param=True)}
    G, plan, _, p = plans(chain(["dist", "dist"]), procs, None)
    w = {"drywet_weight": torch.tensor([[-1.0], [0.5], [2.0], [0.0]][: G.number_of_nodes()])}
    x = torch.tensor(np.random.default_rng(3).standard_normal((1, 2, L)).astype(np.float32))
    params = parameters_from_numpy(p)
    ref = render_grafx(procs, x, params, plan, common_parameters=w)[0]
    streamer = StreamRenderer(procs, plan, params, block_len=BLOCK,
                              common_parameters=w["drywet_weight"] if bare else w)
    state, blocks = streamer.init_state(), []
    for xb in x.split(BLOCK, dim=-1):
        yb, state = streamer(xb, state)
        blocks.append(yb)
    assert max_rel(torch.cat(blocks, -1).numpy(), ref.numpy()) <= STREAM_REL


def test_render_rng_threading():
    """rng= hands each stochastic stage its fold_in(rng, stage): the same
    key renders the same noise, a new key other noise, each equal to
    grafx_tpu's render on that key; rng=None draws the reverb's default
    key, PRNGKey(0), in both; the gradient with a live key equals
    jax.grad's."""
    kw = {"ir_len": 2048, "fixed_noise": False, "processor_channel": "stereo"}
    procs_t = {"reverb": tp.STFTMaskedNoiseReverb(**kw)}
    procs_j = {"reverb": jp.STFTMaskedNoiseReverb(**kw)}
    _, plan_t, plan_j, p = plans(chain(["reverb"]), procs_t, procs_j)
    render_t, render_j = make_render_fn(procs_t, plan_t), j_make_render_fn(procs_j, plan_j)
    x = np.random.default_rng(1).standard_normal((1, 2, L)).astype(np.float32)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    pt, pj = parameters_from_numpy(p), jax.tree.map(jnp.asarray, p)
    outs = {}
    for seed in (10, 20, None):
        jkey, tkey = jkeys(seed) if seed is not None else (None, None)
        ref = render_j(xj, pj, rng=jkey)[0]
        outs[seed] = render_t(xt, pt, rng=tkey)[0].numpy()
        assert max_rel(outs[seed], ref) <= REL, (seed, max_rel(outs[seed], ref))
    np.testing.assert_array_equal(render_t(xt, pt, rng=jkeys(10)[1])[0].numpy(), outs[10])
    assert np.abs(outs[10] - outs[20]).max() > 1e-7

    def loss_j(params):
        return jnp.mean(render_j(xj, params, rng=jkeys(10)[0])[0] ** 2)

    ref = jax.grad(loss_j)(pj)
    params = tree_map(lambda v: v.clone().requires_grad_(True), pt)
    render_grafx(procs_t, xt, params, plan_t, rng=jkeys(10)[1])[0].pow(2).mean().backward()
    for k, v in params["reverb"].items():
        assert np.isfinite(v.grad.numpy()).all()
        assert max_rel(v.grad.numpy(), ref["reverb"][k]) <= GRAD_REL, k


def _chain_procs(pkg):
    return {"fx": pkg.SerialChain({
        "gain": pkg.StereoGain(),
        "rev": pkg.FilteredNoiseShapingReverb(ir_len=1500, num_bands=4,
                                              noise_randomness="pseudo-random",
                                              processor_channel="stereo"),
    })}


def test_render_rng_through_containers():
    """A container hands member i fold_in(noise_key, i): the chained
    reverb's crop follows the key, equal to grafx_tpu's on each key."""
    procs_t, procs_j = _chain_procs(tp), _chain_procs(jp)
    _, plan_t, plan_j, p = plans(chain(["fx"]), procs_t, procs_j)
    render_t, render_j = make_render_fn(procs_t, plan_t), j_make_render_fn(procs_j, plan_j)
    x = np.random.default_rng(1).standard_normal((1, 2, L)).astype(np.float32)
    outs = []
    for seed in (3, 3, 4):
        jkey, tkey = jkeys(seed)
        ref = render_j(jnp.asarray(x), jax.tree.map(jnp.asarray, p), rng=jkey)[0]
        outs.append(render_t(torch.tensor(x), parameters_from_numpy(p), rng=tkey)[0].numpy())
        assert max_rel(outs[-1], ref) <= REL, max_rel(outs[-1], ref)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - outs[2]).max() > 1e-7


def test_stream_with_rng_matches_render_and_grafx_tpu():
    """StreamRenderer(rng=key) draws each stage's noise once at init from
    the render's fold_in(rng, stage): the streamed output equals the
    one-shot render on that key, and grafx_tpu's stream on it."""
    procs_t, procs_j = _chain_procs(tp), _chain_procs(jp)
    _, plan_t, plan_j, p = plans(chain(["fx"]), procs_t, procs_j)
    x = np.random.default_rng(5).standard_normal((1, 2, L)).astype(np.float32)
    jkey, tkey = jkeys(7)
    params = parameters_from_numpy(p)
    one_shot = render_grafx(procs_t, torch.tensor(x), params, plan_t, rng=tkey)[0][0].numpy()
    streamer = StreamRenderer(procs_t, plan_t, params, block_len=BLOCK, rng=tkey)
    jstreamer = JStreamRenderer(procs_j, plan_j, jax.tree.map(jnp.asarray, p),
                                block_len=BLOCK, rng=jkey)
    state, jstate, got, ref = streamer.init_state(), jstreamer.init_state(), [], []
    for k in range(L // BLOCK):
        xb = x[..., k * BLOCK:(k + 1) * BLOCK]
        yb, state = streamer(torch.tensor(xb), state)
        jb, jstate = jstreamer(jnp.asarray(xb), jstate)
        got.append(yb.numpy())
        ref.append(np.asarray(jb))
    got, ref = np.concatenate(got, -1), np.concatenate(ref, -1)
    assert max_rel(got[0], one_shot) <= STREAM_REL, max_rel(got, one_shot)
    assert max_rel(got, ref) <= REL, max_rel(got, ref)


@pytest.mark.parametrize("stream", [False, True], ids=["one_shot", "stream"])
def test_fused_fir_chain_takes_a_key(stream):
    """FusedFIRChain and compose_fir_kernels hand member i
    fold_in(noise_key, i): against grafx_tpu's fused chain on one key,
    rendered whole and streamed."""
    def members(pkg):
        return [("gain", pkg.StereoGain()),
                ("rev", pkg.FilteredNoiseShapingReverb(ir_len=1500, num_bands=4,
                                                       processor_channel="stereo"))]
    fused_t, fused_j = FusedFIRChain(members(tp)), JFusedFIRChain(members(jp))
    rng = np.random.default_rng(6)
    p = {"gain": {"log_gain": rng.standard_normal((2, 2)).astype(np.float32) * 0.3},
         "rev": {k: rng.standard_normal((2, 2, 4)).astype(np.float32) * 0.5
                 for k in ("log_decay", "log_gain")}}
    x = rng.standard_normal((2, 2, L)).astype(np.float32)
    jkey, tkey = jkeys(9)
    ref = fused_j(jnp.asarray(x), noise_key=jkey, **jax.tree.map(jnp.asarray, p))
    with torch.no_grad():
        if stream:
            state, cache = fused_t.stream_init(2, BLOCK, noise_key=tkey, **parameters_from_numpy(p))
            blocks = []
            for xb in torch.tensor(x).split(BLOCK, dim=-1):
                yb, state = fused_t.stream_step(xb, state, cache)
                blocks.append(yb)
            got = torch.cat(blocks, -1).numpy()
        else:
            got = fused_t(torch.tensor(x), noise_key=tkey, **parameters_from_numpy(p)).numpy()
    assert max_rel(got, ref) <= REL, max_rel(got, ref)


def _mimo(GRAFX, NodeConfigs):
    """in -> gain -> s2ms -(mid, side)-> ms2s -> dist -> out."""
    G = GRAFX(config=NodeConfigs({
        "gain": {"inlets": ["main"], "outlets": ["main"]},
        "s2ms": {"inlets": ["main"], "outlets": ["mid", "side"]},
        "ms2s": {"inlets": ["mid", "side"], "outlets": ["main"]},
        "dist": {"inlets": ["main"], "outlets": ["main"]},
    }))
    src, g, sp, mg, d, out = (G.add(t) for t in ("in", "gain", "s2ms", "ms2s", "dist", "out"))
    G.connect(src, g)
    G.connect(g, sp)
    G.connect(sp, mg, outlet="mid", inlet="mid")
    G.connect(sp, mg, outlet="side", inlet="side")
    G.connect(mg, d)
    G.connect(d, out)
    return G


def test_stereo_tools_pass_the_executor_and_the_streamer():
    """The two-outlet StereoToMidSide and the two-inlet MidSideToStereo in
    one graph: the render against grafx_tpu's, the stream against the
    render."""
    def procs(pkg):
        return {"gain": pkg.SideGainImager(), "s2ms": pkg.StereoToMidSide(),
                "ms2s": pkg.MidSideToStereo(), "dist": pkg.ChebyshevDistortion(max_order=5)}
    procs_t, procs_j = procs(tp), procs(jp)
    _, plan_t, plan_j, p = plans(_mimo, procs_t, procs_j)
    x = (0.5 * np.random.default_rng(8).standard_normal((1, 2, L))).astype(np.float32)
    ref = j_make_render_fn(procs_j, plan_j)(jnp.asarray(x), jax.tree.map(jnp.asarray, p))[0]
    params = parameters_from_numpy(p)
    got = render_grafx(procs_t, torch.tensor(x), params, plan_t)[0].numpy()
    assert max_rel(got, ref) <= REL, max_rel(got, ref)
    streamer = StreamRenderer(procs_t, plan_t, params, block_len=BLOCK)
    state, blocks = streamer.init_state(), []
    for xb in torch.tensor(x).split(BLOCK, dim=-1):
        yb, state = streamer(xb, state)
        blocks.append(yb)
    assert max_rel(torch.cat(blocks, -1).numpy(), got) <= STREAM_REL
