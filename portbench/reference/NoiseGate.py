"""Noise gate with the exact one-pole energy smoother and a quadratic
knee: the channels' mean energy through ``y[n] = a y[n-1] + (1 - a)
e[n]`` from 0, its log against the threshold (less 6 dB) through the
gate's knee, and the signal times the gain."""

import torch

from portbench.reference import lti
from portbench.reference.Compressor import EPS, walk_bytes  # noqa: F401 (same walk layer)

# energy 4, one-pole 3, log and offset 3, knee 5, exp 1, gain on 2 channels
FLOPS_PER_SAMPLE = 4 + 3 + 3 + 5 + 1 + 2


def parameter_size(args):
    _check(args)
    return {"log_threshold": (1,), "log_ratio": (1,), "log_knee": (1,), "z_alpha_pre": (1,)}


def _check(args):
    if (args.get("energy_smoother", "iir") != "iir_exact" or args.get("gain_smoother")
            or args.get("knee", "quadratic") != "quadratic"):
        raise NotImplementedError("the reference has the exact one-pole, quadratic-knee gate only")


def knee(log_energy, threshold, log_ratio, log_knee):
    """Log gain of the gate's quadratic knee (``threshold`` already less 6)."""
    ratio = 1.0 + torch.exp(log_ratio)
    half = torch.exp(log_knee) / 2.0
    below = ratio * (log_energy - threshold) + threshold
    middle = log_energy + (1.0 - ratio) * (log_energy - threshold - half) ** 2 / (4.0 * half)
    out = torch.where(log_energy < threshold - half, below,
                      torch.where(log_energy > threshold + half, log_energy, middle))
    return out - log_energy


def render(x, p, args, ctx):
    _check(args)
    energy = torch.mean(x * x, dim=-2)
    alpha = torch.clamp(torch.sigmoid(p["z_alpha_pre"][:, 0]), max=1.0 - 1e-5)
    env = torch.relu(lti.onepole(energy, alpha))
    log_gain = knee(torch.log(env + EPS), p["log_threshold"] - 6.0, p["log_ratio"], p["log_knee"])
    return torch.exp(log_gain)[:, None, :] * x


def flops(rows, channels, length, args):
    return rows * length * FLOPS_PER_SAMPLE
