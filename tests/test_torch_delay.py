"""MultitapDelay and its cores (SurrogateDelay, ZeroPhaseFIR,
TriangularFilterBank) of grafx_tpu_torch against grafx_tpu on the same
numpy inputs and parameters: outputs, the gradients of both parameters
against jax.grad, the aux loss, the FIR-LTI kernel and the stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu.ops.stft import get_window as j_get_window
from grafx_tpu.processors import MultitapDelay as JDelay
from grafx_tpu.processors.core.delay import SurrogateDelay as JSurrogate
from grafx_tpu.processors.core.fft_filterbank import TriangularFilterBank as JFilterBank
from grafx_tpu.processors.core.fir import ZeroPhaseFilterBankFIR as JFilterBankFIR
from grafx_tpu.processors.core.fir import ZeroPhaseFIR as JZeroPhaseFIR
from grafx_tpu.render.streaming import _jit_stream_init
from grafx_tpu_torch.ops.stft import get_window
from grafx_tpu_torch.processors import MultitapDelay
from grafx_tpu_torch.processors.core.delay import SurrogateDelay, normalized_gradient
from grafx_tpu_torch.processors.core.fft_filterbank import SCALES, TriangularFilterBank
from grafx_tpu_torch.processors.core.fir import ZeroPhaseFilterBankFIR, ZeroPhaseFIR

L, B = 2**12, 3
SEGMENT, SEGMENTS = 1500, 10  # _default_processors' delay
# (processor_channel, pre_delay)
MODES = [("mono", 0), ("stereo", 0), ("midside", 0), ("stereo", 37), ("mono", 1000)]


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def delay_inputs(channel, seed, batch=B):
    """Parameters at the scale of a trained delay (|z| ~ 0.5) and noise."""
    rng = np.random.default_rng(seed)
    channels = 1 if channel == "mono" else 2
    num_delay = SEGMENTS * channels
    delay_z = (0.5 * rng.standard_normal((batch, num_delay, 2))).astype(np.float32)
    log_fir = (0.1 * rng.standard_normal((batch, num_delay, 20))).astype(np.float32)
    x = rng.standard_normal((batch, channels, L)).astype(np.float32)
    w = rng.standard_normal((batch, channels, L)).astype(np.float32)
    return delay_z, log_fir, x, w


def both(channel, pre_delay, **kwargs):
    kw = dict(segment_len=SEGMENT, num_segments=SEGMENTS, processor_channel=channel,
              pre_delay=pre_delay, **kwargs)
    return MultitapDelay(**kw), JDelay(**kw)


def complex_z(delay_z):
    return (delay_z[..., 0] + 1j * delay_z[..., 1]).astype(np.complex64)


def soft_firs_float64(delay_z, N=SEGMENT):
    """SurrogateDelay's soft FIRs by the same formula in float64 (numpy),
    ``(B, M, N)``."""
    z = (delay_z[..., 0] + 1j * delay_z[..., 1]).astype(np.complex128)
    z = z * np.tanh(np.abs(z)) / (np.abs(z) + 1e-7)
    return np.fft.irfft((z[..., None] + 1e-7) ** np.arange(N // 2 + 1))


def jax_onsets(delay_z, surrogate):
    """grafx_tpu's hard taps: the argmax of its float32 soft FIRs."""
    irs, _ = surrogate(jnp.asarray(complex_z(delay_z)))
    return np.argmax(np.asarray(irs), axis=-1)


TIE = 1e-5  # of a FIR's peak: far above either package's float32 error (~2e-7)


def agreeing_items(delay_z, onsets_j):
    """Batch items whose hard taps agree between the packages.  Each tap
    where they differ must be a tie: grafx_tpu's float32 pick within TIE
    of the float64 peak that the port picks.  A differing tap changes the
    item's whole output, so only agreeing items compare."""
    exact = soft_firs_float64(delay_z)
    onsets = np.argmax(exact, axis=-1)
    differ = onsets != onsets_j
    for b, m in zip(*np.nonzero(differ)):
        assert exact[b, m, onsets_j[b, m]] >= (1 - TIE) * exact[b, m].max(), (b, m)
    agree = ~differ.any(axis=-1)
    assert agree.any()
    return agree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surrogate_delay_onsets(seed):
    """The port's hard taps equal the float64 soft FIRs' argmax as
    integers, and grafx_tpu's wherever float32 resolves the peak; its soft
    FIRs (complex64 powers (z + 1e-7) ** k, k up to 750, through an irfft)
    within 1e-5 of max|ref| of grafx_tpu's.

    Where the two largest taps of a soft FIR lie closer than float32
    resolves (a tie), grafx_tpu's float32 argmax picks by rounding: at
    seed 1 one FIR of 160 is such a tie, and the packages pick neighbouring
    taps.  The test pins the count of such ties per seed."""
    delay_z = delay_inputs("stereo", seed, batch=8)[0]
    z = torch.tensor(complex_z(delay_z))
    ours, ref = SurrogateDelay(SEGMENT), JSurrogate(SEGMENT, straight_through=False)
    onsets = ours.onsets(z).numpy().reshape(delay_z.shape[:2])
    np.testing.assert_array_equal(onsets, np.argmax(soft_firs_float64(delay_z), axis=-1))
    irs_j, _ = ref(jnp.asarray(complex_z(delay_z)))
    assert max_rel(ours.soft_firs(z.reshape(-1)).numpy(), np.asarray(irs_j).reshape(-1, SEGMENT)) <= 1e-5
    onsets_j = np.argmax(np.asarray(irs_j), axis=-1)
    agreeing_items(delay_z, onsets_j)
    assert (onsets != onsets_j).sum() == {0: 0, 1: 1, 2: 0}[seed]
    hard, _ = ours(z)
    np.testing.assert_array_equal(hard.argmax(-1).numpy(), onsets)
    np.testing.assert_allclose(hard.numpy().max(-1), 1.0, rtol=1e-6)


def test_normalized_gradient_is_identity_with_unit_gradients():
    z = torch.tensor([0.3 + 0.4j, -2.0 + 0.0j, 1e-3j], requires_grad=True)
    y = normalized_gradient(z)
    assert torch.equal(y.detach(), z.detach())
    (y * torch.tensor([3.0 - 4.0j, 0.5 + 0.0j, -1e-4j])).real.sum().backward()
    np.testing.assert_allclose(z.grad.abs().numpy(), 1.0, rtol=1e-3)


@pytest.mark.parametrize("channel, pre_delay", MODES)
def test_multitap_delay_matches_grafx_tpu(channel, pre_delay):
    """Mono, stereo, midside and pre-delayed outputs within max rel 1e-5
    on the batch items whose taps agree as integers (agreeing_items);
    radii_reg within 1e-6 relative."""
    ours, ref = both(channel, pre_delay)
    delay_z, log_fir, x, _ = delay_inputs(channel, len(channel) + pre_delay)
    agree = agreeing_items(delay_z, jax_onsets(delay_z, ref.delay))
    y, aux = ours(torch.tensor(x), torch.tensor(delay_z), torch.tensor(log_fir))
    y_j, aux_j = ref(jnp.asarray(x), jnp.asarray(delay_z), jnp.asarray(log_fir))
    assert y.shape == y_j.shape
    assert max_rel(y.numpy()[agree], np.asarray(y_j)[agree]) <= 1e-5
    np.testing.assert_allclose(aux["radii_reg"].item(), float(aux_j["radii_reg"]), rtol=1e-6)
    if pre_delay:
        assert torch.all(y[..., :pre_delay] == 0)


def _grads(ours, ref, delay_z, log_fir, x, w, dtype=torch.float32):
    """Gradients of sum(y * w) + radii_reg for delay_z and
    log_fir_magnitude: the port's (in ``dtype``) and jax.grad's."""
    dz = torch.tensor(delay_z, dtype=dtype, requires_grad=True)
    lf = torch.tensor(log_fir, dtype=dtype, requires_grad=True)
    y, aux = ours(torch.tensor(x, dtype=dtype), dz, lf)
    ((y * torch.tensor(w, dtype=dtype)).sum() + aux["radii_reg"]).backward()

    def f(dz, lf):
        y, aux = ref(x, dz, lf)
        return jnp.sum(y * w) + aux["radii_reg"]

    g_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(delay_z), jnp.asarray(log_fir))
    return (dz.grad.double().numpy(), lf.grad.double().numpy()), tuple(np.asarray(g) for g in g_j)


@pytest.mark.parametrize("channel, pre_delay", MODES)
def test_multitap_delay_gradients_match_jax_grad(channel, pre_delay):
    """The gradients of delay_z and log_fir_magnitude against jax.grad,
    on the batch items whose taps agree (agreeing_items; an item's
    gradient depends on its own output only).

    The raw gradients (``normalize_gradients=False``) and log_fir_magnitude's
    within 1e-4 of max|ref|.  With the default unit-magnitude gradient of
    each z, a tap whose raw gradient is small (cancellation in the sum
    over 751 powers) gets a direction that float32 fixes only to ~float32
    error / |g|, so grafx_tpu's own float32 gradient can lie well over
    1e-4 of max|ref| from the same formula in float64 (the port run in
    float64).  The port's normalized gradient is held to that float64
    reference: no further from it than 2x grafx_tpu's (plus 1e-6)."""
    delay_z, log_fir, x, w = delay_inputs(channel, 7 + pre_delay)
    ours, ref = both(channel, pre_delay, normalize_gradients=False)
    agree = agreeing_items(delay_z, jax_onsets(delay_z, ref.delay))
    raw, raw_j = _grads(ours, ref, delay_z, log_fir, x, w)
    for got, want in zip(raw, raw_j):
        got, want = got[agree], want[agree]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    ours, ref = both(channel, pre_delay)
    (g_dz, g_lf), (g_dz_j, g_lf_j) = (tuple(g[agree] for g in pair) for pair in
                                      _grads(ours, ref, delay_z, log_fir, x, w))
    g_dz64 = _grads(ours, ref, delay_z, log_fir, x, w, dtype=torch.float64)[0][0][agree]
    scale = np.abs(g_dz64).max()
    own_err, ref_err = np.abs(g_dz - g_dz64).max() / scale, np.abs(g_dz_j - g_dz64).max() / scale
    assert own_err <= 2.0 * ref_err + 1e-6, (own_err, ref_err)
    assert np.abs(g_lf - g_lf_j).max() <= 1e-4 * np.abs(g_lf_j).max()


@pytest.mark.parametrize("channel, pre_delay", [("mono", 0), ("stereo", 37)])
def test_fir_kernel_matches_grafx_tpu_and_the_forward(channel, pre_delay):
    """fir_kernel's IR (pre_delay folded in) against grafx_tpu's (max rel
    1e-5 on the items whose taps agree), its aux equal to the forward's, and the causal convolution
    with it equal to the forward (1e-5 of max|y|); midside raises."""
    ours, ref = both(channel, pre_delay)
    delay_z, log_fir, x, _ = delay_inputs(channel, 11)
    agree = agreeing_items(delay_z, jax_onsets(delay_z, ref.delay))
    ir, shift, aux = ours.fir_kernel(torch.tensor(delay_z), torch.tensor(log_fir))
    ir_j, shift_j, aux_j = ref.fir_kernel(jnp.asarray(delay_z), jnp.asarray(log_fir))
    assert shift == shift_j == 0 and ir.shape == ir_j.shape
    assert ir.shape[-1] == SEGMENT * SEGMENTS + pre_delay
    assert max_rel(ir.numpy()[agree], np.asarray(ir_j)[agree]) <= 1e-5
    np.testing.assert_allclose(aux["radii_reg"].item(), float(aux_j["radii_reg"]), rtol=1e-6)
    from grafx_tpu_torch.ops.fftconv import fft_convolve

    y, _ = ours(torch.tensor(x), torch.tensor(delay_z), torch.tensor(log_fir))
    assert max_rel(fft_convolve(torch.tensor(x), ir, mode="causal").numpy(), y.numpy()) <= 1e-5
    with pytest.raises(NotImplementedError, match="midside"):
        both("midside", 0)[0].fir_kernel(torch.tensor(delay_z), torch.tensor(log_fir))


def _stream(proc, x, params, block):
    if isinstance(x, torch.Tensor):
        state, cache = proc.stream_init(x.shape[-2], block, **params)
    else:  # jitted, as grafx_tpu's StreamRenderer builds it
        state, cache = _jit_stream_init(proc, x.shape[-2], block, params)
    outs = []
    for i in range(x.shape[-1] // block):
        y, state = proc.stream_step(x[..., i * block:(i + 1) * block], state, cache)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1), cache


@pytest.mark.parametrize("channel, pre_delay, block", [
    ("stereo", 0, 1024), ("midside", 0, 1024), ("stereo", 37, 1024), ("mono", 0, 1000),
])
def test_stream_matches_one_shot_and_grafx_tpu(channel, pre_delay, block):
    """Streamed in blocks (1024: a partitioned delay line; 1000: an
    overlap-add tail): against the one-shot forward and against
    grafx_tpu's stream (the items whose taps agree), both <= -60 dB."""
    ours, ref = both(channel, pre_delay)
    delay_z, log_fir, x, _ = delay_inputs(channel, 3)
    agree = agreeing_items(delay_z, jax_onsets(delay_z, ref.delay))
    x = x[..., : 4 * block]
    params = {"delay_z": delay_z, "log_fir_magnitude": log_fir}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    with torch.no_grad():
        got, cache = _stream(ours, torch.tensor(x), tparams, block)
        one_shot = ours(torch.tensor(x), **tparams)[0].numpy()
    assert cache["conv"]["kind"] == ("upols" if block == 1024 else "tail")
    ref_y, _ = _stream(ref, jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, block)
    assert db(got - one_shot, one_shot) <= -60.0
    assert db(got[agree] - ref_y[agree], ref_y[agree]) <= -60.0


def test_parameter_size_matches_grafx_tpu():
    for kw in ({}, {"processor_channel": "mono", "num_delay_per_segment": 3},
               {"zp_filter_per_tap": False, "processor_channel": "midside"}):
        assert MultitapDelay(**kw).parameter_size() == JDelay(**kw).parameter_size()
    with pytest.raises(ValueError, match="channel"):
        MultitapDelay(processor_channel="surround")


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "bartlett", "kaiser", "boxcar"])
def test_zero_phase_fir_matches_grafx_tpu(window):
    """ZeroPhaseFIR and get_window against grafx_tpu (max rel 1e-5)."""
    w, w_j = get_window(window, 39), j_get_window(window, 39)
    assert (w is None) == (w_j is None)
    if w is not None:
        np.testing.assert_array_equal(w, w_j)
    log_mag = (0.3 * np.random.default_rng(4).standard_normal((3, 5, 20))).astype(np.float32)
    got = ZeroPhaseFIR(20, window=window)(torch.tensor(log_mag)).numpy()
    assert max_rel(got, np.asarray(JZeroPhaseFIR(20, window=window)(jnp.asarray(log_mag)))) <= 1e-5


@pytest.mark.parametrize("scale", SCALES)
def test_triangular_filterbank_matches_grafx_tpu(scale):
    """Both modes at every scale: the matrices bit for bit, the products
    within 1e-5 relative; the filterbank FIR as well."""
    ours = TriangularFilterBank(257, num_filters=24, scale=scale)
    ref = JFilterBank(257, num_filters=24, scale=scale)
    np.testing.assert_array_equal(ours.filterbank.numpy(), np.asarray(ref.filterbank))
    rng = np.random.default_rng(len(scale))
    for mode, width in (("analysis", 257), ("synthesis", 24)):
        e = rng.random((4, 7, width)).astype(np.float32)
        got = ours(torch.tensor(e), mode=mode).numpy()
        assert max_rel(got, np.asarray(ref(jnp.asarray(e), mode=mode))) <= 1e-5
    with pytest.raises(ValueError, match="mode"):
        ours(torch.zeros(257), mode="both")
    kw = dict(use_filterbank=True, filterbank_kwargs={"num_filters": 24, "scale": scale})
    log_mag = (0.3 * rng.standard_normal((2, 24))).astype(np.float32)
    got = ZeroPhaseFilterBankFIR(257, **kw)(torch.tensor(log_mag)).numpy()
    assert max_rel(got, np.asarray(JFilterBankFIR(257, **kw)(jnp.asarray(log_mag)))) <= 1e-5
