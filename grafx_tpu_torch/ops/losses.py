"""Audio losses for graph parameter optimization (the port of
:mod:`grafx_tpu.ops.losses`): multi-resolution STFT losses on
:mod:`grafx_tpu_torch.ops.stft`, and plain MAE / MSE."""

import functools

import torch

from grafx_tpu_torch.ops.stft import hann_window, stft


@functools.cache
def _window(n_fft, dtype, device):
    """The Hann window on ``device``, made once: a warm loss copies
    nothing from the host."""
    return torch.as_tensor(hann_window(n_fft), dtype=dtype, device=device)


def _spectrogram(x, n_fft, hop):
    window = _window(n_fft, x.dtype, x.device)
    flat = x.reshape((-1, x.shape[-1]))
    return torch.abs(stft(flat, n_fft, hop, window))


def _stft_loss_from_specs(X, Y, eps):
    sc = torch.linalg.vector_norm(X - Y) / (torch.linalg.vector_norm(Y) + eps)
    log_l1 = torch.mean(torch.abs(torch.log(X + eps) - torch.log(Y + eps)))
    return sc + log_l1


def stft_loss(x, y, n_fft=1024, hop=256, eps=1e-7):
    """Single-resolution STFT loss: spectral convergence + log-magnitude
    L1 (the auraloss ``STFTLoss`` recipe)."""
    X, Y = _spectrogram(x, n_fft, hop), _spectrogram(y, n_fft, hop)
    return _stft_loss_from_specs(X, Y, eps)


def multi_resolution_stft_loss(x, y, n_ffts=(512, 1024, 2048), hop_ratio=4, eps=1e-7):
    """Multi-resolution STFT loss averaged over FFT sizes."""
    losses = [stft_loss(x, y, n_fft=n, hop=n // hop_ratio, eps=eps) for n in n_ffts]
    return sum(losses) / len(losses)


def precompute_stft_targets(y, n_ffts=(512, 1024, 2048), hop_ratio=4):
    """The TARGET spectrograms of the MR-STFT loss, computed once for a
    loop-invariant target (pass them to
    :func:`multi_resolution_stft_loss_precomputed`; with matching
    ``n_ffts``/``hop_ratio`` the loss equals
    :func:`multi_resolution_stft_loss`)."""
    return tuple(_spectrogram(y, n, n // hop_ratio) for n in n_ffts)


def multi_resolution_stft_loss_precomputed(
    x, target_specs, n_ffts=(512, 1024, 2048), hop_ratio=4, eps=1e-7
):
    """MR-STFT loss against spectrograms from
    :func:`precompute_stft_targets`."""
    if len(target_specs) != len(n_ffts):
        raise ValueError(
            f"{len(target_specs)} precomputed spectrograms for"
            f" {len(n_ffts)} FFT sizes — precompute_stft_targets and the"
            " loss must use the same n_ffts."
        )
    losses = [
        _stft_loss_from_specs(_spectrogram(x, n, n // hop_ratio), Y, eps)
        for n, Y in zip(n_ffts, target_specs)
    ]
    return sum(losses) / len(losses)


def mae_loss(x, y):
    return torch.mean(torch.abs(x - y))


def mse_loss(x, y):
    return torch.mean(torch.square(x - y))
