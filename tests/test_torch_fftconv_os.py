"""The one-shot overlap-save and UPOLS convolutions of grafx_tpu_torch
(``ops/fftconv.py``) against its one-FFT ``fft_convolve`` and against
grafx_tpu's forms on the same numpy inputs, with the bounds of
``tests/ops/test_fftconv.py``: outputs rtol 1e-4 (atol 1e-3 overlap-save,
2e-4 UPOLS), gradients rtol 1e-3 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu.ops import fftconv as jconv
from grafx_tpu.processors import FIRFilter as JFIRFilter
from grafx_tpu_torch.ops import fftconv
from grafx_tpu_torch.processors import FIRFilter

OS_CASES = [(5000, 700, None), (2**14, 6000, None), (9999, 128, 512)]
UPOLS_CASES = [(5000, 3000, 512), (4096, 900, 256), (3000, 2561, 1024)]
MODES = ["causal", "zerophase", ("shift", 777)]


def arrays(seed, x_shape, h_shape, h_scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*x_shape).astype(np.float32),
            (rng.randn(*h_shape) * h_scale).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("L,Lh,block", OS_CASES)
def test_overlap_save_matches_one_shot_and_reference(L, Lh, block, mode):
    x, h = arrays(3, (2, 2, L), (2, 2, Lh))
    got = fftconv.fft_convolve_os(torch.tensor(x), torch.tensor(h), mode=mode, block=block).numpy()
    one_shot = fftconv.fft_convolve(torch.tensor(x), torch.tensor(h), mode=mode).numpy()
    ref = np.asarray(jconv.fft_convolve_os(jnp.asarray(x), jnp.asarray(h), mode=mode, block=block))
    assert got.shape == ref.shape == (2, 2, L)
    np.testing.assert_allclose(got, one_shot, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("L,Lh,part", UPOLS_CASES)
def test_upols_matches_one_shot_and_reference(L, Lh, part, mode):
    """Filters shorter and longer than the partition, every crop, and
    filter-side channel broadcasting (a mono signal, a stereo filter)."""
    x, h = arrays(11, (2, 1, L), (2, 2, Lh), 0.05)
    got = fftconv.fft_convolve_upols(torch.tensor(x), torch.tensor(h), mode=mode, part=part).numpy()
    one_shot = fftconv.fft_convolve(torch.tensor(x), torch.tensor(h), mode=mode).numpy()
    ref = np.asarray(jconv.fft_convolve_upols(jnp.asarray(x), jnp.asarray(h), mode=mode, part=part))
    assert got.shape == ref.shape == (2, 2, L)
    np.testing.assert_allclose(got, one_shot, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-4)


def test_overlap_save_broadcasts_filter_channels():
    """A mono signal through a stereo filter keeps the broadcast shape
    (grafx_tpu's regression case, 2000 taps on 2^16)."""
    x, h = arrays(8, (2, 1, 2**16), (2, 2, 2000), 0.02)
    y = fftconv.fft_convolve_os(torch.tensor(x), torch.tensor(h), mode="zerophase", block=14385)
    assert y.shape == (2, 2, 2**16)
    ref = fftconv.fft_convolve(torch.tensor(x), torch.tensor(h), mode="zerophase")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", ["os", "upols"])
def test_gradients_match_jax_grad(form):
    """d mean(y^2) / dh and / dx of each form against ``jax.grad`` of
    grafx_tpu's same form on the same inputs."""
    x, h = arrays(12, (1, 2, 4000), (1, 2, 1500), 0.05)
    kw = {"part": 512} if form == "upols" else {"block": 700}
    fn = getattr(fftconv, f"fft_convolve_{form}")
    jfn = getattr(jconv, f"fft_convolve_{form}")
    xt, ht = torch.tensor(x, requires_grad=True), torch.tensor(h, requires_grad=True)
    fn(xt, ht, **kw).pow(2).mean().backward()
    gx, gh = jax.grad(lambda a, b: jnp.mean(jfn(a, b, **kw) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(h))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("shift", [0, 1000])
@pytest.mark.parametrize("x_len,h_len", [(2**12, 100), (150000, 2000), (2**17, 30000), (2**17, 60000),
                                         (2**18, 2000), (100000, 5000)])
def test_auto_os_block_matches_reference(x_len, h_len, shift):
    assert fftconv._auto_os_block(x_len, h_len, shift) == jconv._auto_os_block(x_len, h_len, shift)


def test_fft_convolve_stays_one_shot():
    """The port keeps one full-length FFT where grafx_tpu would block:
    the output equals the blocked form to round-off either way."""
    x, h = arrays(7, (2, 2, 150000), (2, 2, 2000), 0.03)
    assert jconv._auto_os_block(150000, 2000, 1000) is not None
    got = fftconv.fft_convolve(torch.tensor(x), torch.tensor(h), mode="zerophase").numpy()
    ref = np.asarray(jconv.fft_convolve(jnp.asarray(x), jnp.asarray(h), mode="zerophase"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["causal", "zerophase"])
def test_fir_convolution_overlap_save(mode):
    """``FIRConvolution(overlap_save=True)`` routes a causal convolution to
    overlap-save (a zero-phase one stays one FFT), as in grafx_tpu."""
    x, h = arrays(5, (3, 2, 9000), (3, 1, 300))
    got = fftconv.FIRConvolution(mode=mode, overlap_save=True)(torch.tensor(x), torch.tensor(h)).numpy()
    ref = np.asarray(jconv.FIRConvolution(mode=mode, overlap_save=True)(jnp.asarray(x), jnp.asarray(h)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kwargs", [{"overlap_save": True}, {"flashfftconv": True, "max_input_len": 2**17}])
def test_fir_filter_backend_keywords(kwargs):
    """``FIRFilter`` builds with the reference's backend keywords in both
    packages and renders the same."""
    x, fir = arrays(6, (2, 2, 5000), (2, 1, 255), 0.3)
    got = FIRFilter(**kwargs)(torch.tensor(x), torch.tensor(fir)).numpy()
    ref = np.asarray(JFIRFilter(**kwargs)(jnp.asarray(x), jnp.asarray(fir)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
