"""GraphicEqualizer: 24 bark-band peaking biquads in series with the
neighbour-gain bandwidth correction (Liski et al.), each row's one filter
on every channel; backends as for the parametric equalizer."""

import math

import numpy as np
import torch

from portbench.reference import lti
from portbench.reference.ParametricEqualizer import SECTION_FLOPS

FC_BARK = [50, 150, 250, 350, 450, 570, 700, 840, 1000, 1170, 1370, 1600, 1850,
           2150, 2500, 2900, 3400, 4000, 4800, 5800, 7000, 8500, 10500, 13500]
FB_BARK = [133.3, 160.0, 171.4, 177.8, 214.7, 235.9, 256.7, 294.4, 315.5, 370.8,
           426.9, 466.2, 558.1, 651.0, 744.8, 926.5, 1110.0, 1467.0, 1828.0,
           2194.0, 2735.0, 3619.0, 5333.0, 6000.0]
NEIGHBOUR = 0.4


def _bands(args):
    if args.get("scale", "bark") != "bark" or args.get("processor_channel", "mono") != "mono":
        raise NotImplementedError("the reference has the mono bark equalizer only")
    sr = args.get("sr", 44100)
    fc = np.array(FC_BARK, dtype=np.float64)
    keep = fc < sr / 2
    fb = np.array(FB_BARK[: int(keep.sum())], dtype=np.float64)
    return 2 * math.pi * fc[keep] / sr, fb, sr


def parameter_size(args):
    return {"log_gains": (1, len(_bands(args)[0]))}


def coefficients(p, args):
    wc, fb, sr = _bands(args)
    lg = p["log_gains"][:, 0]
    m2cos = torch.as_tensor(-2 * np.cos(wc), dtype=lg.dtype, device=lg.device).expand(lg.shape)
    tan_half = torch.as_tensor(np.tan(math.pi * fb / sr), dtype=lg.dtype, device=lg.device)
    g = torch.exp(lg)
    g2, n2 = g * g, torch.exp(2 * NEIGHBOUR * lg)
    mult = torch.sqrt((torch.abs(1 - n2) + 1e-7) / (torch.abs(g2 - n2) + 1e-7))
    beta = tan_half * torch.where(torch.abs(lg) >= 1e-3, mult, torch.ones_like(mult))
    Bs = torch.stack([1 + g * beta, m2cos, 1 - g * beta], -1)
    As = torch.stack([1 + beta, m2cos, 1 - beta], -1)
    return Bs, As


def render(x, p, args, ctx):
    Bs, As = coefficients(p, args)
    if args.get("backend", "fsm") == "exact":
        return lti.iir_cascade(x, Bs, As, ctx)
    if args["backend"] != "fsm":
        raise NotImplementedError(f"backend {args['backend']!r}")
    return lti.causal_conv(x, lti.fsm_fir(Bs, As, args.get("fsm_fir_len", 4000))[:, None, :], ctx)


def flops(rows, channels, length, args):
    if args.get("backend", "fsm") == "exact":
        return rows * channels * length * SECTION_FLOPS * len(_bands(args)[0])
    return lti.fft_conv_flops(rows * channels, length, args.get("fsm_fir_len", 4000))
