"""Plain linear filtering for the reference: biquad cascades by their
frequency response, FIRs and impulse responses by FFT convolution.

A biquad cascade (an IIR filter) is applied as ``y = irfft(rfft(x, N)
H_N)[:L]``, with ``H_N`` its response sampled at ``N`` points.  That is the
zero-state recursion up to the impulse response's time aliasing, which
for poles of radius at most ``r`` is below ``r ** (N - L)``; ``N`` is
chosen so that this is under ``exp(-TAIL_LOG)``, far below float64's
rounding, and a pole too close to the unit circle for that raises.
"""

import math

import torch

TAIL_LOG = 45.0  # exp(-45) ~ 3e-20
MAX_FFT = 2**23


def next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def pole_radius(As):
    """The largest pole radius of ``(..., 3)`` denominators."""
    a0, a1, a2 = (As[..., i].detach().double() for i in range(3))
    disc = (a1 / a0) ** 2 - 4 * a2 / a0
    complex_r = torch.sqrt(torch.clamp(a2 / a0, min=0.0))
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    real_r = torch.maximum(torch.abs(-a1 / a0 + root), torch.abs(-a1 / a0 - root)) / 2
    return float(torch.where(disc < 0, complex_r, real_r).max())


def iir_fft_len(length, radius):
    """The FFT length at which a filter with poles of ``radius`` aliases
    by less than ``exp(-TAIL_LOG)``."""
    if radius >= 1.0:
        raise ValueError(f"a pole of radius {radius} is not stable")
    tail = 64 if radius <= 0.0 else math.ceil(TAIL_LOG / -math.log(radius)) + 64
    n = next_pow2(length + tail)
    if n > MAX_FFT:
        raise ValueError(f"poles of radius {radius} need an FFT of {n} points")
    return n


def delays(n_fft, order, dtype, device):
    """``exp(-j w k)`` for ``k = 0..order`` at the ``n_fft // 2 + 1`` bins."""
    w = torch.arange(n_fft // 2 + 1, dtype=dtype, device=device) * (2.0 * math.pi / n_fft)
    k = torch.arange(order + 1, dtype=dtype, device=device)[:, None]
    return torch.polar(torch.ones_like(k * w), -k * w)


def cascade_response(Bs, As, n_fft):
    """``(..., K, 3)`` biquads -> ``(..., n_fft // 2 + 1)`` product of
    their sampled responses."""
    z = delays(n_fft, 2, Bs.dtype, Bs.device)
    h = None
    for k in range(Bs.shape[-2]):
        num = (Bs[..., k, :, None] * z).sum(-2)
        den = (As[..., k, :, None] * z).sum(-2)
        h = num / den if h is None else h * (num / den)
    return h


def iir_cascade(x, Bs, As, ctx):
    """Apply ``(n, K, 3)`` cascades to ``(n, C, L)`` signals (each row's
    filter to all its channels), zero initial state.  A control rounds
    the operands of the filtering (the signal and the first ``L`` taps of
    the impulse response) by ``ctx.operand``."""
    length = x.shape[-1]
    n_fft = iir_fft_len(length, pole_radius(As))
    H = cascade_response(Bs, As, n_fft)[:, None, :]
    if ctx.operand is None:
        return torch.fft.irfft(torch.fft.rfft(x, n=n_fft) * H, n=n_fft)[..., :length]
    return causal_conv(x, torch.fft.irfft(H, n=n_fft)[..., :length], ctx)


def onepole(x, alpha):
    """``y[n] = alpha y[n-1] + (1 - alpha) x[n]``, ``y[-1] = 0``, for
    ``(n, L)`` signals and ``(n,)`` coefficients."""
    length = x.shape[-1]
    n_fft = iir_fft_len(length, float(alpha.detach().abs().max()))
    z = delays(n_fft, 1, x.dtype, x.device)
    H = (1.0 - alpha)[:, None] / (1.0 - alpha[:, None] * z[1])
    return torch.fft.irfft(torch.fft.rfft(x, n=n_fft) * H, n=n_fft)[..., :length]


def causal_conv(x, h, ctx):
    """Linear convolution of ``(n, C, L)`` with ``(n, C_h, L_h)``, the first
    ``L`` samples; a control rounds both operands by ``ctx.operand``."""
    if ctx.operand is not None:
        x, h = ctx.operand(x), ctx.operand(h)
    length = x.shape[-1]
    n_fft = next_pow2(length + h.shape[-1] - 1)
    y = torch.fft.irfft(torch.fft.rfft(x, n=n_fft) * torch.fft.rfft(h, n=n_fft), n=n_fft)
    return y[..., :length]


def fsm_fir(Bs, As, fir_len):
    """The frequency-sampling method's FIR: the cascade's response at
    ``fir_len // 2 + 1`` bins, inverse-transformed to ``fir_len`` taps."""
    return torch.fft.irfft(cascade_response(Bs, As, fir_len), n=fir_len)


def fft_flops(n):
    """Operations of one real FFT of ``n`` points (2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def fft_conv_flops(rows, length, taps):
    """An FFT convolution of ``rows`` signals with as many filters: three
    real transforms and the complex product."""
    n = next_pow2(length + taps - 1)
    return rows * (3 * fft_flops(n) + 3 * n)
