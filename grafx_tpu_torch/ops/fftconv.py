"""FFT-based convolution on ``torch.fft``.

The port of :mod:`grafx_tpu.ops.fftconv`.  The JAX package's
:func:`fft_convolve` splits long convolutions into overlap-save or
partitioned blocks (``_auto_os_block``) because long 1-D FFTs are slow on
the TPU; here :func:`fft_convolve` is always one full-length FFT, and the
blocked forms are their own functions: :func:`fft_convolve_os`
(overlap-save) and :func:`fft_convolve_upols` (uniformly partitioned
overlap-save), which ``FIRConvolution(overlap_save=True)`` and callers
may pick.  All compute the same linear convolution, so the results agree
to float32 round-off (the tests state the bound).

Streaming (:func:`conv_stream_init` / :func:`conv_stream_apply`) carries
a short filter's overlap-add tail, and a long filter's frequency-domain
delay line of uniformly partitioned overlap-save (UPOLS), as
``grafx_tpu`` does.
"""

import torch
import torch.nn.functional as F

_UPOLS_PART = 1 << 13  # the largest streaming partition (FFT size 2^14)
# grafx_tpu's blocking rule (its AUTO_OS dispatch, tuned on the TPU):
# FFT lengths above _AUTO_OS_LONG_FFT are blocked, never below
# _AUTO_OS_MIN_NFFT points a block
_AUTO_OS_LONG_FFT = 1 << 17
_AUTO_OS_MIN_NFFT = 1 << 14


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << (int(n) - 1).bit_length()


def _auto_os_block(x_len: int, h_len: int, shift: int):
    """``grafx_tpu``'s blocked-convolution decision for these lengths:
    ``None`` (one full-length FFT), ``("os", block)`` or ``("upols",
    part)``.  The port's :func:`fft_convolve` does not follow it; it says
    which form the reference would run (``chip_smoke.py`` times all three)."""
    span = h_len + shift  # filter history + zero-phase lookahead
    if next_pow2(x_len + span - 1) <= _AUTO_OS_LONG_FFT:
        return None
    if next_pow2(span) > _UPOLS_PART:
        return ("upols", _UPOLS_PART)
    nfft = max(2 * next_pow2(span), _AUTO_OS_MIN_NFFT)
    block = nfft - (span - 1)  # the largest alias-free hop (not a power of two)
    if -(-x_len // block) < 2:
        return None
    return ("os", block)


def _shift(mode, h_len, name):
    if isinstance(mode, tuple) and mode[0] == "shift":
        return int(mode[1])
    if mode == "causal":
        return 0
    if mode == "zerophase":
        return h_len // 2
    raise ValueError(f"Unsupported {name} mode: {mode}")


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
    (reference: core/convolution.py:17-106).  ``overlap_save`` routes a
    causal convolution to :func:`fft_convolve_os`; the reference's
    ``flashfftconv`` / ``max_input_len`` are accepted and ignored, as in
    ``grafx_tpu``."""

    def __init__(self, mode="causal", pad_mode="pow2", overlap_save=False,
                 **_ignored_backend_kwargs):
        if mode not in ("causal", "zerophase"):
            raise ValueError(f"Unsupported convolution mode: {mode}")
        self.mode = mode
        self.pad_mode = pad_mode
        self.overlap_save = overlap_save

    def __call__(self, input_signals, fir):
        if self.overlap_save and self.mode == "causal":
            return fft_convolve_os(input_signals, fir)
        return fft_convolve(input_signals, fir, mode=self.mode, pad_mode=self.pad_mode)


def fft_convolve_os(x, h, mode="causal", block=None):
    """Overlap-save blocked FFT convolution, cropped to ``L_x``: many
    transforms of ``next_pow2(block + L_h - 1 + shift)`` points in place
    of one long one; the same linear convolution as :func:`fft_convolve`.

    Args:
        x: ``(..., L_x)``; h: ``(..., L_h)`` (leading dims broadcast).
        mode: ``"causal"``, ``"zerophase"`` or ``("shift", s)``.
        block: output hop per block (any length: the FFT length confines
            the circular wrap-around to each block's discarded leading
            samples); default ``max(next_pow2(L_h), 4096)``.
    """
    L, Lh = x.shape[-1], h.shape[-1]
    shift = _shift(mode, Lh, "overlap-save")
    if block is None:
        block = max(next_pow2(Lh), 4096)
    nfft = next_pow2(block + Lh - 1 + shift)
    nb = -(-L // block)
    pad_tail = nb * block - L + shift + (nfft - block - Lh + 1)
    xp = F.pad(x, (Lh - 1, pad_tail))
    # block k reads xp[k * block : k * block + nfft]: a strided view
    segs = xp.unfold(-1, nfft, block)[..., :nb, :]  # (..., nb, nfft)
    X = torch.fft.rfft(segs, n=nfft)
    H = torch.fft.rfft(h, n=nfft)[..., None, :]
    start = Lh - 1 + shift
    y = torch.fft.irfft(X * H, n=nfft)[..., start : start + block]
    # leading dims broadcast between x and h: flatten on the broadcast shape
    return y.reshape(y.shape[:-2] + (nb * block,))[..., :L]


def fft_convolve_upols(x, h, mode="causal", part=8192):
    """Uniformly partitioned overlap-save (UPOLS): the filter in ``m``
    chunks of ``part`` taps, the signal in hops of ``part`` (transforms
    of ``2 * part`` points whatever ``L_h`` is); output segment ``k`` is
    ``irfft(sum_j X[k - j] H[j])``.  The same linear convolution as
    :func:`fft_convolve`.

    Args:
        x: ``(..., L_x)``; h: ``(..., L_h)`` (leading dims broadcast).
        mode: ``"causal"``, ``"zerophase"`` or ``("shift", s)``.
        part: chunk and hop length.

    Returns:
        ``(..., L_x)`` convolved signals.
    """
    L, Lh = x.shape[-1], h.shape[-1]
    shift = _shift(mode, Lh, "UPOLS")
    C, nfft = part, 2 * part
    m = -(-Lh // C)
    nb = -(-(L + shift) // C)
    xp = F.pad(x, (C, nb * C - L))  # (nb + 1) * C samples
    # segment k holds x[kC - C : kC + C]: two views of the hop grid
    S = xp.reshape(xp.shape[:-1] + (nb + 1, C))
    X = torch.fft.rfft(torch.cat([S[..., :-1, :], S[..., 1:, :]], dim=-1), n=nfft)
    H = torch.fft.rfft(F.pad(h, (0, m * C - Lh)).reshape(h.shape[:-1] + (m, C)), n=nfft)
    # Y[k] = sum_j X[k - j] H[j]; the segment axis padded in front, so
    # that segments before the signal's start read zeros
    Xp = F.pad(X, (0, 0, m - 1, 0))
    Y = None
    for j in range(m):
        term = Xp[..., m - 1 - j : m - 1 - j + nb, :] * H[..., j : j + 1, :]
        Y = term if Y is None else Y + term
    y = torch.fft.irfft(Y, n=nfft)[..., C:]  # (..., nb, C): the valid halves
    y = y.reshape(y.shape[:-2] + (nb * C,))
    return y[..., shift : shift + L]


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
