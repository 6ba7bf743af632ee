"""The streaming slice against grafx_tpu: kernel #7's plain version
against the Pallas kernels ``_kernel`` and ``_kernel_nat`` in interpret
mode, the stateful ops and processors streamed block by block, and
``StreamRenderer`` on a mini console and on the fused bench.py console
(4 chains, L = 4096, blocks of 1024)."""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch import nn

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.ops import fftconv as j_fftconv
from grafx_tpu.ops import iir as j_iir
from grafx_tpu.ops.ballistics_tpu import LANES, expand_lanes, forward_pallas_tm, pad_time_major
from grafx_tpu.render import StreamRenderer as JStreamRenderer
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.render.streaming import _jit_stream_init
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import bench_console
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.ops.fftconv import conv_stream_apply, conv_stream_init, fft_convolve
from grafx_tpu_torch.ops.iir import (
    biquad_exact,
    biquad_exact_apply,
    biquad_exact_build,
    biquad_exact_zero_state,
    onepole_exact,
)
from grafx_tpu_torch.processors.core.envelope import Ballistics, TruncatedOnePoleIIRFilter
from grafx_tpu_torch.render import (
    StreamRenderer,
    fuse_parameters,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import create_empty_parameters, parameters_from_numpy
from test_torch_graph import FUSE, jax_processors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, BLOCK = 4096, 1024


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def peak_rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def blocks(x, block=BLOCK):
    return [x[..., k * block : (k + 1) * block] for k in range(x.shape[-1] // block)]


# ---------------------------------------------------------------------------
# (a) kernel #7: the plain walk against _kernel and _kernel_nat
# ---------------------------------------------------------------------------

CHUNK = 64  # small chunk so tiny shapes still cross chunk boundaries
NAT_CHUNK = 256  # _kernel_nat walks 128-sample tiles of its chunk


def _layout_kernel():
    """``_kernel_nat`` of benchmarks/ballistics_layout_ab.py (a script,
    loaded from its file)."""
    path = os.path.join(REPO, "benchmarks", "ballistics_layout_ab.py")
    spec = importlib.util.spec_from_file_location("ballistics_layout_ab", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._kernel_nat


def _natural_pallas(u, zi, at, rt, chunk=NAT_CHUNK):
    """``_kernel_nat`` in a ``pallas_call(interpret=True)`` on natural
    ``(N, L)`` rows padded to 128 rows and to the chunk in time, as
    ``forward_pallas_natural`` lays them out."""
    N, n = u.shape
    S = -(-N // LANES)
    Np, Lp = S * LANES, -(-n // chunk) * chunk
    lane = pl.BlockSpec((8, LANES), lambda s, i: (s, 0), memory_space=pltpu.VMEM)
    nat = pl.BlockSpec((LANES, chunk), lambda s, i: (s, i), memory_space=pltpu.VMEM)
    y = pl.pallas_call(
        functools.partial(_layout_kernel(), chunk=chunk),
        grid=(S, Lp // chunk),
        in_specs=[lane, lane, lane, nat],
        out_specs=nat,
        out_shape=jax.ShapeDtypeStruct((Np, Lp), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, LANES), jnp.float32)],
        interpret=True,
    )(*(expand_lanes(jnp.asarray(v), S) for v in (zi, at, rt)),
      jnp.pad(jnp.asarray(u), ((0, Np - N), (0, Lp - n))))
    return np.asarray(y[:N, :n])


def _time_major_pallas(u, zi, at, rt):
    N, n = u.shape
    S = -(-N // LANES)
    y = forward_pallas_tm(
        pad_time_major(jnp.asarray(u), CHUNK),
        *(expand_lanes(jnp.asarray(v), S) for v in (zi, at, rt)),
        chunk=CHUNK, interpret=True,
    )
    return np.asarray(y[:n, :N].T)


def _walk_inputs(N, n, seed):
    rng = np.random.RandomState(seed)
    u = np.abs(rng.randn(N, n)).astype(np.float32)
    zi = np.abs(rng.randn(N)).astype(np.float32)
    at = rng.uniform(0.01, 0.9, N).astype(np.float32)
    rt = rng.uniform(0.01, 0.9, N).astype(np.float32)
    return u, zi, at, rt


@pytest.mark.parametrize("reference", ["_kernel", "_kernel_nat"])
@pytest.mark.parametrize("N, n", [(3, 200), (37, 301), (130, 96)])
def test_ballistics_plain_matches_pallas(reference, N, n):
    """The plain version of kernel #7 against the Pallas forward it
    replaces (time-major ``_kernel``) and the natural-layout experiment
    (``_kernel_nat``), ragged in rows and time; the bound of
    tests/ops/test_ballistics_pallas.py."""
    args = _walk_inputs(N, n, N + n)
    ref = (_time_major_pallas if reference == "_kernel" else _natural_pallas)(*args)
    before = bal.launch_counts()["ballistics_core"]
    got = bal.ballistics_core(*(torch.tensor(a) for a in args)).numpy()
    assert bal.launch_counts()["ballistics_core"] == before  # CPU tensors: plain version
    np.testing.assert_array_equal(got, bal.ballistics_plain(*(torch.tensor(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n, split", [(4096, 2048), (301, 150)])
def test_ballistics_state_carry_is_exact(n, split):
    """Walking [0, s) and then [s, L), carrying the walk's stream state
    (the state entering the link [0, s) ended in and that link's samples
    so far), equals one walk over [0, L) bit for bit."""
    u, zi, at, rt = (torch.tensor(a) for a in _walk_inputs(5, n, 3))
    whole = bal.ballistics_core(u, zi, at, rt)
    first, state = bal.ballistics_stream(u[:, :split], bal.walk_state(zi), at, rt)
    second, _ = bal.ballistics_stream(u[:, split:], state, at, rt)
    np.testing.assert_array_equal(torch.cat([first, second], 1).numpy(), whole.numpy())


def _chain_case(n):
    """A gate -> compressor dynamics chain, both gain-smoothed, on ``n``
    rows: ``(consts, zi, spec)`` of random parameters."""
    from grafx_tpu_torch.processors.dynamics import dynamics_chain, gain_op, request_states

    members = [tp.NoiseGate(energy_smoother="ballistics", gain_smoother="ballistics"),
               tp.Compressor(energy_smoother="iir_exact", gain_smoother="ballistics",
                             gain_smooth_in_log=True)]
    spec = gain_op(members).spec
    gen = torch.Generator().manual_seed(n)
    runs = []
    for proc in members:
        params = {k: 0.5 * torch.randn(n, size, generator=gen) for k, size in proc.parameter_size().items()}
        runs.append((proc, params))
    consts, inits = dynamics_chain(spec, runs)
    return consts, request_states(consts, inits), spec


@pytest.mark.parametrize("block", [1, 7, 9, 441, 1000])
def test_streams_of_any_block_equal_one_call(block):
    """Kernel #7's walk and the dynamics chain (#11) streamed in blocks of
    any length, whole links or not, from the walks' stream states:
    equal to one call over the stream bit for bit; blocks of whole links
    leave the carried tail empty."""
    n = 3 * block + 5
    u, zi, at, rt = (torch.tensor(a) for a in _walk_inputs(4, n, block))
    consts, czi, spec = _chain_case(4)
    whole = bal.ballistics_core(u, zi, at, rt)
    chain_whole = bal.ballistics_chain_core(u, consts, czi, spec)[0]
    state, chain_state, ys, gains = bal.walk_state(zi), bal.walk_state(czi), [], []
    for lo in range(0, n, block):
        y, state = bal.ballistics_stream(u[:, lo:lo + block], state, at, rt)
        g, chain_state = bal.ballistics_chain_stream(u[:, lo:lo + block], consts, chain_state, spec)
        ys.append(y)
        gains.append(g)
        assert state[1].shape[1] == chain_state[1].shape[1] == min(lo + block, n) % bal.WALK_LINK
    np.testing.assert_array_equal(torch.cat(ys, 1).numpy(), whole.numpy())
    np.testing.assert_array_equal(torch.cat(gains, 1).numpy(), chain_whole.numpy())


@pytest.mark.parametrize("block", [441, 1024])
def test_streamed_dynamics_equal_the_one_shot_render(block):
    """A console of gain-smoothed compressors (the dynamics chain) and
    ballistics compressors (the smoother walk, #7, and the knee) streamed
    by StreamRenderer in blocks of 441 samples (10 ms at 44.1 kHz, not
    whole links) or 1024: the chain's stage equal to the one-shot render's
    bit for bit, the console within the one-shot's bound."""
    procs = {"chain": tp.Compressor(energy_smoother="ballistics", gain_smoother="ballistics"),
             "comp": tp.Compressor(energy_smoother="ballistics")}
    G = GRAFX(config=NodeConfigs(sorted(procs)))
    ends = [G.add_serial_chain(["in", kind])[1] for kind in ("chain", "chain", "comp")]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(procs, G, std=0.3, generator=torch.Generator().manual_seed(block))
    x = torch.tensor(np.random.default_rng(5).standard_normal((3, 2, 4 * block)).astype(np.float32))
    streamer = StreamRenderer(procs, plan, params, block_len=block)
    state, outs = streamer.init_state(), []
    for xb in blocks(x, block):
        y, state = streamer(xb, state)
        outs.append(y)
    got = torch.cat(outs, -1).numpy()
    with torch.inference_mode():
        ref = make_render_fn(procs, plan)(x, params)[0].numpy()
    assert peak_rel(got, ref) < 5e-4
    chain_only = {"chain": procs["chain"]}
    Gc = GRAFX(config=NodeConfigs(["chain"]))
    Gc.connect(Gc.add_serial_chain(["in", "chain"])[1], Gc.add("out"))
    plan_c = prepare_render(reorder_for_fast_render(convert_to_tensor(Gc), method="beam"))
    params_c = {"chain": {k: v[:1] for k, v in params["chain"].items()}}
    streamer = StreamRenderer(chain_only, plan_c, params_c, block_len=block)
    state, outs = streamer.init_state(), []
    for xb in blocks(x[:1], block):
        y, state = streamer(xb, state)
        outs.append(y)
    with torch.inference_mode():
        ref = make_render_fn(chain_only, plan_c)(x[:1], params_c)[0]
    np.testing.assert_array_equal(torch.cat(outs, -1).numpy(), ref.numpy())


def test_ballistics_core_streams_without_grad_and_differentiates():
    """(g) The streamed smoother runs under ``no_grad`` (the primal walk,
    #7) and the same calls differentiate (the walk with residuals and its
    adjoint, #8/#9, here their plain versions): the output is the same
    walk bit for bit, and a gradient flows to ``z_alpha``."""
    u, zi, at, rt = (torch.tensor(a) for a in _walk_inputs(2, 64, 4))
    smoother, z_alpha = Ballistics(), torch.zeros(2, 2, requires_grad=True)
    with torch.no_grad():
        first, state = smoother.stream(u[:, :32], smoother.stream_zero_state(2), z_alpha)
        second, _ = smoother.stream(u[:, 32:], state, z_alpha)
    whole = smoother(u, z_alpha)
    assert whole.requires_grad
    np.testing.assert_array_equal(torch.cat([first, second], 1).numpy(), whole.detach().numpy())
    whole.sum().backward()
    assert z_alpha.grad is not None and bool(torch.isfinite(z_alpha.grad).all())
    assert bool((z_alpha.grad != 0).all())
    at_ = at.clone().requires_grad_()
    bal.ballistics_core(u, zi, at_, rt).sum().backward()
    assert bool((at_.grad != 0).all())


def test_ballistics_core_refuses_other_devices():
    u = torch.empty(2, 8, device="meta")
    c = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bal.ballistics_core(u, c, c, c)


# ---------------------------------------------------------------------------
# (b)-(d) the stateful ops, streamed
# ---------------------------------------------------------------------------


def _onepole_stream(fn, x, alpha, state):
    outs = []
    for xb in blocks(x):
        y, state = fn(xb, alpha, state_in=state, return_state=True)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1)


def test_onepole_exact_matches_grafx_tpu():
    """(b) One-shot and streamed, against grafx_tpu's, and streamed against
    one-shot (tests/ops/test_streaming.py:121-123)."""
    rng = np.random.RandomState(3)
    N = 5
    alpha = rng.uniform(0.3, 0.999, N).astype(np.float32)
    x = np.abs(rng.randn(N, L)).astype(np.float32)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-4, atol=1e-5)
    tx, ta = torch.tensor(x), torch.tensor(alpha)
    one_shot = onepole_exact(tx, ta).numpy()
    close(one_shot, np.asarray(j_iir.onepole_exact(jnp.asarray(x), jnp.asarray(alpha))))
    streamed = _onepole_stream(onepole_exact, tx, ta, torch.zeros(N))
    close(streamed, _onepole_stream(j_iir.onepole_exact, jnp.asarray(x), jnp.asarray(alpha),
                                    jnp.zeros(N)))
    close(streamed, one_shot)
    # a length that is not a power of two pads the last block
    close(onepole_exact(tx[:, :3000], ta).numpy(), one_shot[:, :3000])


def _random_biquads(rng, N, K, r_hi=0.99):
    r = rng.uniform(0.2, r_hi, (N, K))
    th = rng.uniform(0.02, np.pi - 0.02, (N, K))
    As = np.stack([np.ones_like(r), -2 * r * np.cos(th), r**2], -1)
    return torch.tensor(rng.randn(N, K, 3), dtype=torch.float32), torch.tensor(As, dtype=torch.float32)


@pytest.mark.parametrize("K", [1, 2, 6, 24])
def test_biquad_exact_stream_matches_one_shot(K):
    """(c) Both cache layouts (per stage for K <= 2, one cascade beyond),
    tests/ops/test_streaming.py:61-87."""
    rng = np.random.RandomState(1)
    N, T = 4, 128
    Bs, As = _random_biquads(rng, N, K)
    x = torch.tensor(rng.randn(N, L), dtype=torch.float32)
    ref = biquad_exact(x, Bs, As, block_size=T).numpy()
    cache = biquad_exact_build(Bs, As, block_size=T)
    state = biquad_exact_zero_state(cache, N)
    assert state.shape == ((N, 2 * K) if K > 2 else (N, K, 2))
    outs = []
    for xb in blocks(x, 512):
        y, state = biquad_exact_apply(xb, cache, block_size=T, state_in=state, return_state=True)
        outs.append(y.numpy())
    assert peak_rel(np.concatenate(outs, -1), ref) < 1e-4


def test_biquad_exact_stream_rejects_partial_blocks():
    Bs, As = _random_biquads(np.random.RandomState(2), 2, 4)
    cache = biquad_exact_build(Bs, As, block_size=128)
    with pytest.raises(ValueError, match="multiple"):
        biquad_exact_apply(torch.zeros(2, 100), cache, block_size=128,
                           state_in=biquad_exact_zero_state(cache, 2), return_state=True)


@pytest.mark.parametrize("h_len, block", [(20000, 4096), (6000, 2048), (500, 1024)])
def test_conv_stream_matches_causal(h_len, block):
    """(d) UPOLS delay line for long filters, overlap-add tail for short
    ones, chosen as grafx_tpu chooses (tests/ops/test_streaming.py:150-174)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 2, block * 6).astype(np.float32)
    h = (rng.randn(2, 2, h_len) * 0.02).astype(np.float32)
    ref = fft_convolve(torch.tensor(x), torch.tensor(h), mode="causal").numpy()
    state, cache = conv_stream_init(torch.tensor(h), 2, block)
    assert cache["kind"] == j_fftconv.conv_stream_init(jnp.asarray(h), 2, block)[1]["kind"]
    assert (cache["kind"] == "upols") == (h_len > 2 * min(8192, block))
    outs = []
    for xb in blocks(torch.tensor(x), block):
        y, state = conv_stream_apply(xb, state, cache)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, -1), ref, rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the smoothers and processors, against grafx_tpu's, one-shot and streamed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["exact", "truncated", "ballistics"])
def test_smoother_forward_matches_grafx_tpu(kind):
    from grafx_tpu.processors.core import envelope as j_env

    rng = np.random.RandomState(8)
    x = np.abs(rng.randn(3, 3000)).astype(np.float32)
    z = rng.randn(3, 2 if kind == "ballistics" else 1).astype(np.float32)
    ours, theirs = {
        "exact": (TruncatedOnePoleIIRFilter(exact=True), j_env.TruncatedOnePoleIIRFilter(exact=True)),
        "truncated": (TruncatedOnePoleIIRFilter(iir_len=2000), j_env.TruncatedOnePoleIIRFilter(iir_len=2000)),
        "ballistics": (Ballistics(), j_env.Ballistics()),
    }[kind]
    got = ours(torch.tensor(x), torch.tensor(z)).numpy()
    ref = np.asarray(theirs(jnp.asarray(x), jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _processor_pairs():
    return {
        "comp_gain_smoothed": (
            tp.Compressor(energy_smoother="ballistics", gain_smoother="iir_exact"),
            jp.Compressor(energy_smoother="ballistics", gain_smoother="iir_exact"),
        ),
        "gate_log_ballistics": (
            tp.NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                         gain_smooth_in_log=True, knee="hard"),
            jp.NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                         gain_smooth_in_log=True, knee="hard"),
        ),
        "peq_midside": (
            tp.ParametricEqualizer(num_filters=4, processor_channel="midside", backend="exact"),
            jp.ParametricEqualizer(num_filters=4, processor_channel="midside", backend="exact"),
        ),
        "geq": (tp.GraphicEqualizer(backend="exact"), jp.GraphicEqualizer(backend="exact")),
        "peak": (tp.PeakingFilter(backend="exact"), jp.PeakingFilter(backend="exact")),
        "reverb_midside": (
            tp.STFTMaskedNoiseReverb(ir_len=3000, processor_channel="midside"),
            jp.STFTMaskedNoiseReverb(ir_len=3000, processor_channel="midside"),
        ),
    }


def _stream_processor(proc, x, params):
    if isinstance(x, torch.Tensor):
        state, cache = proc.stream_init(2, BLOCK, **params)
    else:  # jitted, as grafx_tpu's StreamRenderer builds it
        state, cache = _jit_stream_init(proc, 2, BLOCK, params)
    outs = []
    for xb in blocks(x):
        y, state = proc.stream_step(xb, state, cache)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("name", list(_processor_pairs()))
def test_processor_stream_matches_grafx_tpu(name):
    """Each stateful processor of the slice streamed in blocks of 1024:
    against grafx_tpu's stream, and against its own one-shot forward."""
    ours, theirs = _processor_pairs()[name]
    rng = np.random.RandomState(len(name))
    params = {
        k: (0.5 * rng.randn(3, *((v,) if isinstance(v, int) else v))).astype(np.float32)
        for k, v in ours.parameter_size().items()
    }
    x = rng.randn(3, 2, L).astype(np.float32)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    with torch.no_grad():
        got = _stream_processor(ours, torch.tensor(x), tparams)
        one_shot = ours(torch.tensor(x), **tparams).numpy()
    ref = _stream_processor(theirs, jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    assert db(got - ref, ref) <= -60.0, db(got - ref, ref)
    assert peak_rel(got, one_shot) < 5e-4


def test_reverb_stream_refuses_noise_key():
    """A per-stream noise_key (once refused, before RNG threading): the
    reverb with per-call noise streamed from its stream_init on a key,
    against grafx_tpu's stream on the same key, and against its own
    one-shot forward on that key."""
    from grafx_tpu_torch import random as tr

    ours = tp.STFTMaskedNoiseReverb(ir_len=3000, fixed_noise=False)
    theirs = jp.STFTMaskedNoiseReverb(ir_len=3000, fixed_noise=False)
    rng = np.random.RandomState(11)
    params = {k: (0.5 * rng.randn(2, *v)).astype(np.float32)
              for k, v in ours.parameter_size().items()}
    x = rng.randn(2, 2, L).astype(np.float32)
    jkey = jax.random.PRNGKey(2**31 + 7)
    tkey = tr.key_from_numpy(np.asarray(jkey))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    with torch.no_grad():
        got = _stream_processor(ours, torch.tensor(x), {**tparams, "noise_key": tkey})
        one_shot = ours(torch.tensor(x), **tparams, noise_key=tkey).numpy()
    ref = _stream_processor(theirs, jnp.asarray(x),
                            {**{k: jnp.asarray(v) for k, v in params.items()}, "noise_key": jkey})
    assert db(got - ref, ref) <= -60.0, db(got - ref, ref)
    assert peak_rel(got, one_shot) < 5e-4


def test_truncated_smoother_does_not_stream():
    with pytest.raises(NotImplementedError, match="exact"):
        TruncatedOnePoleIIRFilter().stream_zero_state(3)


# ---------------------------------------------------------------------------
# (e)-(f) StreamRenderer
# ---------------------------------------------------------------------------


def _mini_console(GR, NC, procs):
    """tests/graph/test_render_streaming.py:135-169's console."""
    G = GR(config=NC(sorted(procs)))
    ends = []
    for i in range(3):
        chain = ["in", "eq", "compressor", "gain"]
        if i % 2 == 0:
            chain.insert(1, "geq")
        if i == 1:
            chain.insert(2, "noisegate")
        if i == 2:
            chain.append("dist")
        ends.append(G.add_serial_chain(chain)[1])
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    rev = G.add("reverb")
    G.connect(mix, rev)
    master = G.add("mix")
    G.connect(rev, master)
    G.connect(mix, master)
    G.connect(master, G.add("out"))
    return G


def _mini_processors(lib):
    return {
        "eq": lib.ParametricEqualizer(num_filters=4, backend="exact"),
        "geq": lib.GraphicEqualizer(scale="bark", backend="exact"),
        "compressor": lib.Compressor(energy_smoother="ballistics"),
        "noisegate": lib.NoiseGate(energy_smoother="iir_exact"),
        "gain": lib.StereoGain(),
        "dist": lib.TanhDistortion(),
        "reverb": lib.STFTMaskedNoiseReverb(ir_len=3000),
    }


def _stream(streamer, x):
    state = streamer.init_state()
    outs = []
    for xb in blocks(x):
        y, state = streamer(xb, state)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1)


def _jax_stream(G, procs, params, x):
    plan = j_prepare(j_reorder(j_convert(G), method="beam", use_native=False))
    return plan, _stream(JStreamRenderer(procs, plan, params, block_len=BLOCK), jnp.asarray(x))


@pytest.fixture(scope="module")
def mini():
    procs_j = _mini_processors(jp)
    Gj = _mini_console(JGRAFX, JNodeConfigs, procs_j)
    params_j = jax.tree.map(np.asarray, j_create_params(procs_j, Gj, std=0.3, key=jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal((3, 2, L)).astype(np.float32)
    plan_j, ref = _jax_stream(Gj, procs_j, params_j, x)

    procs = _mini_processors(tp)
    G = _mini_console(GRAFX, NodeConfigs, procs)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    assert dataclasses.asdict(plan) == dataclasses.asdict(plan_j)
    return dict(procs=procs, plan=plan, params=parameters_from_numpy(params_j), x=x, ref=ref)


@pytest.fixture(scope="module")
def console():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", 4)
        Gj = bench.build_mix_graph()
    procs_j = jax_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(7))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    x = np.random.default_rng(2).standard_normal((4, 2, L)).astype(np.float32)
    _, ref = _jax_stream(Gj2, procs_j2, params_j2, x)

    c = bench_console(4, device="cpu")
    params = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    return dict(procs=c.fused_processors, plan=c.plan, params=params, x=x, ref=ref)


@pytest.mark.parametrize("graph", ["mini", "console"])
def test_stream_renderer_matches_grafx_tpu(graph, request):
    """(e) The port's stream against grafx_tpu's (unfused mini console;
    the fused bench console with migrated parameters) within -60 dB, and
    against the port's own one-shot render (max-abs / peak < 5e-4)."""
    g = request.getfixturevalue(graph)
    streamer = StreamRenderer(g["procs"], g["plan"], g["params"], block_len=BLOCK)
    before = bal.launch_counts()
    got = _stream(streamer, torch.tensor(g["x"]))
    assert bal.launch_counts() == before  # CPU tensors: plain versions
    assert got.shape == g["ref"].shape == (1, 2, L)
    assert np.isfinite(got).all()
    assert db(got - g["ref"], g["ref"]) <= -60.0, db(got - g["ref"], g["ref"])
    with torch.inference_mode():
        one_shot = make_render_fn(g["procs"], g["plan"])(torch.tensor(g["x"]), g["params"])[0]
    assert peak_rel(got, one_shot.numpy()) < 5e-4


def test_step_many_equals_single_steps(mini):
    """(f) k blocks per call equal k single calls, outputs and state."""
    streamer = StreamRenderer(mini["procs"], mini["plan"], mini["params"], block_len=BLOCK)
    x = torch.tensor(mini["x"])
    state = streamer.init_state()
    singles = []
    for xb in blocks(x):
        y, state = streamer(xb, state)
        singles.append(y)
    many, state_many = streamer.step_many(torch.stack(blocks(x)), streamer.init_state())
    for a, b in zip(singles, many):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)
    flat = [(a, b) for i in state for a, b in zip(_leaves(state[i]), _leaves(state_many[i]))]
    assert flat
    for a, b in flat:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="x_blocks"):
        streamer.step_many(x[None, ..., : BLOCK - 1], state)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, tuple):  # a walk's stream state: (last, tail)
        return [leaf for t in tree for leaf in _leaves(t)]
    return [] if tree is None else [tree]


def _eq_plan(block_size=128):
    procs = {"eq": tp.ParametricEqualizer(num_filters=4, backend="exact",
                                          exact_block_size=block_size)}
    G = GRAFX(config=NodeConfigs(sorted(procs)))
    G.add_serial_chain(["in", "eq", "out"])
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    return procs, plan, create_empty_parameters(procs, G)


def test_stream_renderer_rejects_bad_blocks_and_options():
    procs, plan, params = _eq_plan()
    with pytest.raises(ValueError, match="multiple"):
        StreamRenderer(procs, plan, params, block_len=1000)  # not a multiple of 128
    streamer = StreamRenderer(procs, plan, params, block_len=BLOCK)
    with pytest.raises(ValueError, match="block length"):
        streamer(torch.zeros(1, 2, 512), streamer.init_state())
    # rng and common_parameters (once refused, before RNG threading): on a
    # graph with no stochastic stage the stream equals grafx_tpu's with
    # the same options
    from grafx_tpu_torch import random as tr

    x = np.random.RandomState(12).randn(1, 2, 2 * BLOCK).astype(np.float32)
    jprocs = {"eq": jp.ParametricEqualizer(num_filters=4, backend="exact", exact_block_size=128)}
    G = JGRAFX(config=JNodeConfigs(sorted(jprocs)))
    G.add_serial_chain(["in", "eq", "out"])
    jplan = j_prepare(j_reorder(j_convert(G), method="beam"))
    jparams = {"eq": {k: jnp.asarray(v.numpy()) for k, v in params["eq"].items()}}
    for option, joption in (({"rng": tr.PRNGKey(3)}, {"rng": jax.random.PRNGKey(3)}),
                            ({"common_parameters": {}}, {"common_parameters": {}})):
        streamer = StreamRenderer(procs, plan, params, block_len=BLOCK, **option)
        jstreamer = JStreamRenderer(jprocs, jplan, jparams, block_len=BLOCK, **joption)
        state, jstate = streamer.init_state(), jstreamer.init_state()
        for xb in np.split(x, 2, axis=-1):
            y, state = streamer(torch.tensor(xb), state)
            jy, jstate = jstreamer(jnp.asarray(xb), jstate)
            assert db(y.numpy() - np.asarray(jy), np.asarray(jy)) <= -60.0, option


class _Ducker(nn.Module):
    """Two-inlet stateful test processor: the key input's ballistics-
    smoothed energy ducks the main input (the multi-inlet streaming
    contract, ``stream_step(main, key, state, cache)``)."""

    def __init__(self):
        super().__init__()
        self.smoother = Ballistics()

    def forward(self, main, key, z_alpha, log_depth):
        env = self.smoother(torch.mean(torch.square(key), dim=-2), z_alpha=z_alpha)
        return torch.exp(-torch.exp(log_depth) * env)[:, None, :] * main

    def parameter_size(self):
        return {"z_alpha": 2, "log_depth": 1}

    def stream_init(self, num_channels, block_len, z_alpha, log_depth):
        state = self.smoother.stream_zero_state(z_alpha.shape[0])
        return state, {"z_alpha": z_alpha, "log_depth": log_depth}

    def stream_step(self, main, key, state, cache):
        e = torch.mean(torch.square(key), dim=-2)
        env, state = self.smoother.stream(e, state, z_alpha=cache["z_alpha"])
        return torch.exp(-torch.exp(cache["log_depth"]) * env)[:, None, :] * main, state


class _BadDucker(_Ducker):
    def stream_step(self, main, state, cache):  # missing `key`
        return main, state


@pytest.mark.parametrize("ducker", [_Ducker, _BadDucker])
def test_stream_multi_inlet(ducker):
    """A two-inlet stateful node streams when its stream_step takes one
    signal per inlet, and is refused when it does not."""
    procs = {"duck": ducker(), "eq": tp.ParametricEqualizer(num_filters=4, backend="exact")}
    G = GRAFX(config=NodeConfigs({
        "duck": {"inlets": ["main", "key"], "outlets": ["main"]},
        "eq": {"inlets": ["main"], "outlets": ["main"]},
    }))
    a, b, eq, duck = G.add("in"), G.add("in"), G.add("eq"), G.add("duck")
    G.connect(a, eq)
    G.connect(eq, duck, inlet="main")
    G.connect(b, duck, inlet="key")
    G.connect(duck, G.add("out"))
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(procs, G, std=0.3)
    if ducker is _BadDucker:
        with pytest.raises(NotImplementedError, match="positional args"):
            StreamRenderer(procs, plan, params, block_len=BLOCK)
        return
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 2, L)).astype(np.float32))
    got = _stream(StreamRenderer(procs, plan, params, block_len=BLOCK), x)
    with torch.inference_mode():
        ref = make_render_fn(procs, plan)(x, params)[0].numpy()
    assert peak_rel(got, ref) < 5e-4
