"""ParametricEqualizer: a low shelf, peaking filters and a high shelf
(RBJ cookbook biquads) in series, each row's one filter on every channel.
The exact backend is the recursion itself; the fsm backend is the
cascade's response sampled at ``fsm_fir_len // 2 + 1`` bins, inverse
transformed to an FIR of ``fsm_fir_len`` taps, and convolved causally."""

import math

import torch

from portbench.reference import lti

SECTION_FLOPS = 9  # a biquad sample: 5 multiplies, 4 adds


def parameter_size(args):
    k = args.get("num_filters", 10)
    return {"w0": (1, k), "q_inv": (1, k), "log_gain": (1, k)}


def _check(args):
    if args.get("processor_channel", "mono") != "mono" or not args.get("use_shelving_filters", True):
        raise NotImplementedError("the reference has the mono, shelving equalizer only")
    if args.get("backend", "fsm") not in ("exact", "fsm"):
        raise NotImplementedError(f"backend {args['backend']!r}")


def coefficients(p):
    """``(n, K, 3)`` numerators and denominators."""
    w0 = math.pi * torch.sigmoid(p["w0"][:, 0])
    q_inv = torch.exp(p["q_inv"][:, 0])
    A = torch.exp(p["log_gain"][:, 0])
    cos, alpha = torch.cos(w0), torch.sin(w0) * q_inv * 0.5
    sqA2a = 2 * torch.sqrt(A) * alpha
    Ap, Am = A + 1, A - 1
    peak_b = torch.stack([1 + alpha * A, -2 * cos, 1 - alpha * A], -1)
    peak_a = torch.stack([1 + alpha / A, -2 * cos, 1 - alpha / A], -1)
    low_b = torch.stack([A * (Ap - Am * cos + sqA2a), 2 * A * (Am - Ap * cos),
                         A * (Ap - Am * cos - sqA2a)], -1)
    low_a = torch.stack([Ap + Am * cos + sqA2a, -2 * (Am + Ap * cos), Ap + Am * cos - sqA2a], -1)
    high_b = torch.stack([A * (Ap + Am * cos + sqA2a), -2 * A * (Am + Ap * cos),
                          A * (Ap + Am * cos - sqA2a)], -1)
    high_a = torch.stack([Ap - Am * cos + sqA2a, 2 * (Am - Ap * cos), Ap - Am * cos - sqA2a], -1)
    Bs = torch.cat([low_b[:, :1], peak_b[:, 1:-1], high_b[:, -1:]], 1)
    As = torch.cat([low_a[:, :1], peak_a[:, 1:-1], high_a[:, -1:]], 1)
    return Bs, As


def render(x, p, args, ctx):
    _check(args)
    Bs, As = coefficients(p)
    if args.get("backend", "fsm") == "exact":
        return lti.iir_cascade(x, Bs, As, ctx)
    return lti.causal_conv(x, lti.fsm_fir(Bs, As, args.get("fsm_fir_len", 4000))[:, None, :], ctx)


def flops(rows, channels, length, args):
    if args.get("backend", "fsm") == "exact":
        return rows * channels * length * SECTION_FLOPS * args.get("num_filters", 10)
    return lti.fft_conv_flops(rows * channels, length, args.get("fsm_fir_len", 4000))
