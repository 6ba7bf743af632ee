"""STFT / inverse STFT with torch-compatible conventions.

The port of :mod:`grafx_tpu.ops.stft`: ``center=True`` with reflect
padding, periodic windows, and iSTFT synthesis normalized by the summed
squared window envelope.  The JAX package runs small inverse DFTs as
matmuls because that suits the TPU; here ``torch.fft.irfft`` does it.
The reflect padding is built from narrows and flips, whose backward adds
in a fixed order: torch's ``reflection_pad1d`` backward adds by atomics
on the card, and ``torch.use_deterministic_algorithms`` refuses it.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _reflect_pad(x, pad: int):
    """``x`` with ``pad`` samples mirrored about each end of its last dim,
    the edge samples not repeated (``jnp.pad``'s ``"reflect"`` mode,
    value for value; ``torch``'s too, where ``pad < length``).  A pad as
    long as the signal or longer reflects again past its ends, as
    ``jnp.pad`` does: the padded signal repeats with period
    ``2 * (length - 1)`` (a one-sample signal repeats)."""
    length = x.shape[-1]
    if length == 0:
        raise ValueError("reflect padding needs a signal of at least one sample")
    if pad < length:
        left = x.narrow(-1, 1, pad).flip(-1)
        right = x.narrow(-1, length - 1 - pad, pad).flip(-1)
        return torch.cat([left, x, right], dim=-1)
    period = x if length == 1 else torch.cat([x, x.narrow(-1, 1, length - 2).flip(-1)], dim=-1)
    n = period.shape[-1]
    start, total = (-pad) % n, length + 2 * pad
    return torch.cat([period] * -(-(start + total) // n), dim=-1).narrow(-1, start, total)


def stft(x, n_fft: int, hop_length: int, window):
    """Short-time Fourier transform.

    Args:
        x: ``(..., L)`` real signals.
        window: length ``n_fft`` tensor.

    Returns:
        Complex spectrogram ``(..., n_fft // 2 + 1, num_frames)`` with
        ``num_frames = 1 + L // hop_length`` (center=True convention).
    """
    lead, L = x.shape[:-1], x.shape[-1]
    xp = _reflect_pad(x.reshape(-1, L), n_fft // 2)
    frames = xp.unfold(-1, n_fft, hop_length)  # (M, num_frames, n_fft)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return spec.transpose(-1, -2).reshape(lead + spec.shape[-1:] + spec.shape[-2:-1])


def istft(spec, n_fft: int, hop_length: int, window, length: int):
    """Inverse STFT via windowed overlap-add (torch.istft convention).

    Args:
        spec: ``(..., n_fft // 2 + 1, num_frames)`` complex spectrogram.
        length: output length (center padding removed).
    """
    lead = spec.shape[:-2]
    num_frames = spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    total = n_fft + hop_length * (num_frames - 1)

    def overlap_add(fr):  # (M, num_frames, n_fft) -> (M, total)
        return F.fold(
            fr.transpose(1, 2),
            output_size=(1, total),
            kernel_size=(1, n_fft),
            stride=(1, hop_length),
        ).reshape(fr.shape[0], total)

    y = overlap_add(frames.reshape((-1, num_frames, n_fft)))
    w2 = (window * window).expand(1, num_frames, n_fft)
    wsq = overlap_add(w2)[0]
    y = y / torch.clamp(wsq, min=1e-11)
    start = n_fft // 2
    return y[:, start : start + length].reshape(lead + (length,))


def hann_window(n: int, periodic: bool = True):
    """Periodic Hann window (torch.hann_window convention), as numpy."""
    denom = n if periodic else n - 1
    t = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * t / denom))


def get_window(window_type, window_length: int, **kwargs):
    """Window factory (reference: core/fir.py:7-22), as numpy; ``None``
    for a rectangular window."""
    if window_type in ("rectangular", "none", "boxcar", None):
        return None
    match window_type:
        case "hann":
            return hann_window(window_length)
        case "hamming":
            t = np.arange(window_length)
            return 0.54 - 0.46 * np.cos(2 * np.pi * t / window_length)
        case "blackman":
            t = 2 * np.pi * np.arange(window_length) / window_length
            return 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2 * t)
        case "bartlett":
            t = np.arange(window_length)
            return 1.0 - np.abs(2.0 * t / window_length - 1.0)
        case "kaiser":
            beta = kwargs.get("beta", 12.0)
            return np.kaiser(window_length + 1, beta)[:-1]
        case _:
            raise ValueError(f"Unsupported window type: {window_type}")
