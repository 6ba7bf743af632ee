"""grafx_tpu_torch ops against grafx_tpu (and scipy float64): FFT
convolution, STFT / iSTFT and the exact blocked IIR cascade."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from grafx_tpu.ops import fftconv as jfft
from grafx_tpu.ops import iir as jiir
from grafx_tpu.ops.losses import multi_resolution_stft_loss as j_mrstft
from grafx_tpu_torch.ops import fftconv, iir
from grafx_tpu_torch.ops.losses import multi_resolution_stft_loss

# the packages' ops/__init__ re-export a function named stft over the module
jstft = importlib.import_module("grafx_tpu.ops.stft")
stft = importlib.import_module("grafx_tpu_torch.ops.stft")


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / (np.linalg.norm(ref) + 1e-30))


@pytest.mark.parametrize(
    "x_shape, h_shape, mode, pad_mode",
    [
        ((3, 2, 1000), (3, 1, 257), "causal", "pow2"),
        ((3, 2, 1000), (3, 2, 257), "zerophase", "min"),
        ((2, 1, 777), (2, 2, 64), ("shift", 40), "pow2"),
        ((2, 2, 300), (2, 2, 50), "full", "pow2"),
        # the reverb's shape: JAX splits it into partitioned overlap-save
        # blocks, the port runs one full-length FFT
        ((2, 2, 2**17), (2, 2, 30000), "causal", "pow2"),
        ((2, 2, 2**17), (2, 1, 4001), "zerophase", "pow2"),
    ],
)
def test_fft_convolve_matches_jax(x_shape, h_shape, mode, pad_mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=x_shape).astype(np.float32)
    h = rng.normal(size=h_shape).astype(np.float32) / np.sqrt(h_shape[-1])
    ref = np.asarray(jfft.fft_convolve(jnp.asarray(x), jnp.asarray(h), mode=mode, pad_mode=pad_mode))
    got = fftconv.fft_convolve(torch.tensor(x), torch.tensor(h), mode=mode, pad_mode=pad_mode)
    assert got.shape == ref.shape
    # the bound of tests/ops/test_fftconv.py (blocked vs direct FFT conv)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=2e-4)
    assert db(got.numpy() - ref, ref) < -100


@pytest.mark.parametrize(
    "n_fft, hop, length",
    [(384, 192, 30000), (512, 128, 4000), (400, 160, 3001), (4096, 1024, 8192), (256, 64, 257)],
)
def test_stft_istft_match_jax(n_fft, hop, length):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 2, length)).astype(np.float32)
    win = jstft.hann_window(n_fft).astype(np.float32)
    spec_ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(win)))
    spec = stft.stft(torch.tensor(x), n_fft, hop, torch.tensor(win))
    assert spec.shape == spec_ref.shape
    # the bounds of tests/ops/test_stft.py
    np.testing.assert_allclose(spec.numpy(), spec_ref, rtol=1e-3, atol=1e-4)

    mask = rng.uniform(0.1, 1.0, size=spec_ref.shape).astype(np.float32)
    y_ref = np.asarray(
        jstft.istft(jnp.asarray(spec_ref * mask), n_fft, hop, jnp.asarray(win), length)
    )
    y = stft.istft(torch.tensor(spec_ref * mask), n_fft, hop, torch.tensor(win), length)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(stft.hann_window(n_fft), jstft.hann_window(n_fft))


@pytest.mark.parametrize("length", [1024, 700, 300])
def test_mrstft_loss_of_a_signal_no_longer_than_the_pad_matches_jax(length):
    """Signals of n_fft // 2 samples or fewer (the MR-STFT loss's
    2048-point FFT pads 1024 on each side): the STFT and the loss against
    grafx_tpu's, whose jnp.pad reflects again past the signal's ends."""
    rng = np.random.default_rng(length)
    x, y = (rng.normal(size=(1, 2, length)).astype(np.float32) for _ in range(2))
    win = jstft.hann_window(2048).astype(np.float32)
    spec_ref = np.asarray(jstft.stft(jnp.asarray(x), 2048, 512, jnp.asarray(win)))
    spec = stft.stft(torch.tensor(x), 2048, 512, torch.tensor(win))
    assert spec.shape == spec_ref.shape
    # the bounds of tests/ops/test_stft.py
    np.testing.assert_allclose(spec.numpy(), spec_ref, rtol=1e-3, atol=1e-4)
    ref = float(j_mrstft(jnp.asarray(x), jnp.asarray(y)))
    assert multi_resolution_stft_loss(torch.tensor(x), torch.tensor(y)).item() == pytest.approx(ref, rel=1e-5)


def random_stable_biquads(rng, n, k):
    """As tests/ops/test_iir.py: pole/zero radii < 1."""
    pole_r = rng.uniform(0.2, 0.95, (n, k))
    pole_th = rng.uniform(0, np.pi, (n, k))
    zero_r = rng.uniform(0.2, 0.95, (n, k))
    zero_th = rng.uniform(0, np.pi, (n, k))
    Bs = np.stack([np.ones((n, k)), -2 * zero_r * np.cos(zero_th), zero_r**2], -1)
    As = np.stack([np.ones((n, k)), -2 * pole_r * np.cos(pole_th), pole_r**2], -1)
    return Bs.astype(np.float32), As.astype(np.float32)


def scipy_cascade(x, Bs, As):
    y = x.astype(np.float64)
    for i in range(x.shape[0]):
        for k in range(Bs.shape[1]):
            y[i] = scipy.signal.lfilter(Bs[i, k].astype(np.float64), As[i, k].astype(np.float64), y[i])
    return y


@pytest.mark.parametrize(
    "L, K, block",
    [(1000, 1, 512), (4096, 2, 128), (3000, 8, 128)],
)
def test_biquad_exact_matches_jax_and_scipy(L, K, block):
    rng = np.random.RandomState(0)
    x = rng.randn(4, L).astype(np.float32)
    Bs, As = random_stable_biquads(rng, 4, K)
    Bs[..., :] *= rng.uniform(0.5, 2.0, (4, K, 1)).astype(np.float32)  # un-normalized
    ref = scipy_cascade(x, Bs, As)
    scale = np.abs(ref).max()
    y_jax = np.asarray(jiir.biquad_exact(jnp.array(x), jnp.array(Bs), jnp.array(As), block_size=block))
    args = (torch.tensor(x), torch.tensor(Bs), torch.tensor(As))
    y = iir.biquad_exact(*args, block_size=block).numpy()
    # the bound of tests/ops/test_iir.py, against scipy and against JAX
    assert np.abs(y - ref).max() / scale < 1e-4
    assert np.abs(y - y_jax).max() / scale < 1e-4
    cache = iir.biquad_exact_build(args[1], args[2], block_size=block)
    y_cached = iir.biquad_exact_apply(args[0], cache, block_size=block).numpy()
    if L >= block:  # biquad_exact clamps the block to next_pow2(L)
        np.testing.assert_allclose(y_cached, y, rtol=1e-6, atol=1e-6 * scale)


def test_exactness_check_db():
    assert iir.exactness_check_db() <= -60.0
