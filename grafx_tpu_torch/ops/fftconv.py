"""FFT-based convolution on ``torch.fft``.

The port of :func:`grafx_tpu.ops.fftconv.fft_convolve` and
:class:`~grafx_tpu.ops.fftconv.FIRConvolution`.  The JAX package splits
long convolutions into overlap-save or partitioned blocks because long
1-D FFTs are slow on the TPU; here every convolution is one full-length
FFT.  Both compute the same linear convolution, so the results agree to
float32 round-off (the tests state the bound).
"""

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << (int(n) - 1).bit_length()


def compute_pad_len(x_len: int, h_len: int, pad_mode: str = "pow2") -> int:
    """FFT length for a full linear convolution of lengths ``x_len`` and
    ``h_len`` (reference: core/convolution.py:109-117)."""
    full = x_len + h_len - 1
    if pad_mode == "pow2":
        return next_pow2(full)
    if pad_mode == "min":
        return full
    raise ValueError(f"Unsupported pad_mode: {pad_mode}")


def _crop_params(x_len: int, h_len: int, n: int, mode):
    """(start, length) of the output window within the length-``n``
    circular convolution; ``mode`` is ``"causal"``, ``"zerophase"``,
    ``"full"`` or ``("shift", s)``."""
    if isinstance(mode, tuple) and mode[0] == "shift":
        return int(mode[1]), x_len
    if mode == "zerophase":
        return h_len // 2, x_len
    if mode == "causal":
        return 0, x_len
    if mode == "full":
        return 0, n
    raise ValueError(f"Unsupported convolution mode: {mode}")


def fft_convolve(x, h, mode="zerophase", pad_mode="pow2"):
    """Batched linear convolution via real FFT.

    Args:
        x: input signals ``(..., L_x)``; leading dims broadcast against ``h``.
        h: FIR filters ``(..., L_h)``.
        mode: ``"causal"`` keeps ``y[..., :L_x]``; ``"zerophase"`` keeps a
            window starting at ``L_h // 2``; ``("shift", s)`` one starting
            at ``s``; ``"full"`` returns the whole padded product.
        pad_mode: ``"pow2"`` or ``"min"`` FFT length.
    """
    x_len, h_len = x.shape[-1], h.shape[-1]
    n = compute_pad_len(x_len, h_len, pad_mode)
    X = torch.fft.rfft(x, n=n)
    H = torch.fft.rfft(h, n=n)
    y = torch.fft.irfft(X * H, n=n)
    start, out_len = _crop_params(x_len, h_len, n, mode)
    return y[..., start : start + out_len]


class FIRConvolution:
    """A stateless FIR convolution mirroring the reference API
    (reference: core/convolution.py:17-106)."""

    def __init__(self, mode="causal", pad_mode="pow2"):
        if mode not in ("causal", "zerophase"):
            raise ValueError(f"Unsupported convolution mode: {mode}")
        self.mode = mode
        self.pad_mode = pad_mode

    def __call__(self, input_signals, fir):
        return fft_convolve(input_signals, fir, mode=self.mode, pad_mode=self.pad_mode)
