"""Compressor with a ballistics energy smoother and a quadratic knee: the
channels' mean energy, smoothed by the attack/release walk from 1, its
log against the threshold (less 6 dB) through the knee, and the signal
times the gain."""

import torch

from portbench.reference.walk import ballistics

EPS = 1e-5
# a sample: energy (2 squares, add, scale), walk (subtract, compare,
# multiply, add), log and offset, knee (5), exp, the gain on 2 channels
FLOPS_PER_SAMPLE = 4 + 4 + 3 + 5 + 1 + 2


def parameter_size(args):
    _check(args)
    return {"log_threshold": (1,), "log_ratio": (1,), "log_knee": (1,), "z_alpha_pre": (2,)}


def _check(args):
    if (args.get("energy_smoother", "iir") != "ballistics" or args.get("gain_smoother")
            or args.get("knee", "quadratic") != "quadratic"):
        raise NotImplementedError("the reference has the ballistics, quadratic-knee compressor only")


def knee(log_energy, threshold, log_ratio, log_knee):
    """Log gain of the quadratic knee (``threshold`` already less 6)."""
    ratio = 1.0 + torch.exp(log_ratio)
    half = torch.exp(log_knee) / 2.0
    above = threshold + (log_energy - threshold) / ratio
    middle = log_energy + (1.0 / ratio - 1.0) * (log_energy - threshold + half) ** 2 / (4.0 * half)
    out = torch.where(log_energy < threshold - half, log_energy,
                      torch.where(log_energy > threshold + half, above, middle))
    return out - log_energy


def render(x, p, args, ctx):
    _check(args)
    energy = torch.mean(x * x, dim=-2)
    ts = torch.sigmoid(p["z_alpha_pre"])
    env = ballistics(energy, ts[:, 0], ts[:, 1], torch.ones_like(ts[:, 0]))
    log_gain = knee(torch.log(env + EPS), p["log_threshold"] - 6.0, p["log_ratio"], p["log_knee"])
    return torch.exp(log_gain)[:, None, :] * x


def flops(rows, channels, length, args):
    return rows * length * FLOPS_PER_SAMPLE


def walk_bytes(rows, length, train):
    """Bytes the walk layer needs in float32: the energy in and the gain
    out, and under training the energy and the gain's cotangent in and
    the energy's cotangent out."""
    return 4 * rows * length * (5 if train else 2)
