"""FFT-based convolution on ``torch.fft``.

The port of :func:`grafx_tpu.ops.fftconv.fft_convolve` and
:class:`~grafx_tpu.ops.fftconv.FIRConvolution`.  The JAX package splits
long convolutions into overlap-save or partitioned blocks because long
1-D FFTs are slow on the TPU; here every convolution is one full-length
FFT.  Both compute the same linear convolution, so the results agree to
float32 round-off (the tests state the bound).

Streaming (:func:`conv_stream_init` / :func:`conv_stream_apply`) carries
a short filter's overlap-add tail, and a long filter's frequency-domain
delay line of uniformly partitioned overlap-save (UPOLS), as
``grafx_tpu`` does.
"""

import torch
import torch.nn.functional as F

_UPOLS_PART = 1 << 13  # the largest streaming partition (FFT size 2^14)


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


def conv_stream_zero_tail(lead_shape, h_len, dtype=torch.float32, device=None):
    """Initial (zero) overlap-add tail for :func:`fft_convolve_stream`:
    shape ``lead_shape + (h_len - 1,)``."""
    return torch.zeros(tuple(lead_shape) + (max(h_len - 1, 0),), dtype=dtype, device=device)


def fft_convolve_stream(x, h, tail):
    """One block of a streaming causal FIR convolution (overlap-add).

    The full linear convolution of the block plus the carried tail: its
    first ``B`` samples are this block's output, the other ``L_h - 1``
    the next tail.  Any block split reproduces the one-shot
    ``fft_convolve(mode="causal")`` to float round-off.

    Args:
        x: block ``(..., B)``.
        h: FIR ``(..., L_h)`` (longer than ``B`` is fine: the tail spans
            several future blocks).
        tail: ``(..., L_h - 1)`` from the previous step
            (:func:`conv_stream_zero_tail` initially).

    Returns:
        ``(y_block (..., B), new_tail (..., L_h - 1))``.
    """
    B = x.shape[-1]
    Lt = h.shape[-1] - 1
    acc = fft_convolve(x, h, mode="full")[..., : B + Lt]
    if Lt:
        acc = acc + F.pad(tail, (0, B))
    return acc[..., :B], acc[..., B:]


def conv_stream_init(h, num_channels, block_len):
    """Start a streaming causal convolution with filter ``h`` ``(B, C_h,
    L_h)``; returns ``(state, cache)`` for :func:`conv_stream_apply`.

    A filter longer than two partitions, where the block is a whole
    number of partitions, carries UPOLS state: the last ``m - 1``
    segment spectra, so each block's transforms stay at ``2 * part``
    points whatever ``L_h`` is.  Others carry an overlap-add tail."""
    B, C_h, Lh = h.shape
    C_bc = max(num_channels, C_h)
    part = min(_UPOLS_PART, next_pow2(block_len))
    if not (Lh > 2 * part and block_len % part == 0):
        return (
            conv_stream_zero_tail((B, C_bc), Lh, h.dtype, h.device),
            {"kind": "tail", "h": h},
        )
    nfft = 2 * part
    m = -(-Lh // part)
    H = torch.fft.rfft(F.pad(h, (0, m * part - Lh)).reshape(B, C_h, m, part), n=nfft)
    state = {
        "X": torch.zeros((B, C_bc, m - 1, nfft // 2 + 1), dtype=H.dtype, device=h.device),
        "xtail": h.new_zeros((B, C_bc, part)),
    }
    # X[..., i, :] holds the spectrum of segment k-1-(m-2-i), which pairs
    # with H_{m-1-i}: H_1..H_{m-1} are stored reversed, so a step is one
    # product and a sum over the segment axis
    cache = {
        "kind": "upols",
        "H0": H[..., 0, :],
        "Hrev": torch.flip(H[..., 1:, :], dims=[-2]),
        "part": part,
    }
    return state, cache


def conv_stream_apply(x, state, cache):
    """One streaming block through a convolution started by
    :func:`conv_stream_init`; returns ``(y_block, new_state)``."""
    if cache["kind"] == "tail":
        return fft_convolve_stream(x, cache["h"], state)
    H0, Hrev, part = cache["H0"], cache["Hrev"], cache["part"]
    nfft = 2 * part
    X, xtail = state["X"], state["xtail"]
    xb = x.expand(X.shape[:2] + (x.shape[-1],))
    outs = []
    for s in range(x.shape[-1] // part):
        xs = xb[..., s * part : (s + 1) * part]
        Xk = torch.fft.rfft(torch.cat([xtail, xs], dim=-1), n=nfft)
        # Y_k = sum_j X_{k-j} H_j
        Y = Xk * H0 + torch.sum(X * Hrev, dim=-2)
        outs.append(torch.fft.irfft(Y, n=nfft)[..., part:])
        X = torch.cat([X[..., 1:, :], Xk[..., None, :]], dim=-2)
        xtail = xs
    return torch.cat(outs, dim=-1), {"X": X, "xtail": xtail}
