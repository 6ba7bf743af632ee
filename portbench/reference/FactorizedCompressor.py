"""Compressor whose energy is smoothed at frame rate (``grafx_tpu``'s
``FactorizedCompressor(frame_len=1024)``; GRAFX ships the class as a
constructor stub, dynamics.py:724-739): the channels' mean energy
``e``, mean-pooled into frames of ``FRAME_LEN`` samples (the last frame
zero-padded on the right, and divided by ``FRAME_LEN`` all the same),
the frames smoothed by the attack/release walk from 1, that envelope
taken back to the sample rate by a linear interpolation between frame
centres, flat before the first centre and after the last, then the
compressor's quadratic knee on its log against the threshold (less
6 dB), and the signal times the gain:

    m[i] = sum(e[i F : (i + 1) F]) / F           (e zero past L)
    s = walk(m; sigmoid(z_alpha_pre); 1)
    v[n] = interp((n + 0.5) / F - 0.5; i -> s[i])
    y = exp(knee(log(v + 1e-5); log_threshold - 6, log_ratio, log_knee)) x

Departures from the port's ``_FrameSmoother``: the interpolation is
written as a gather of the two neighbouring frames at each sample's
position, clamped at the ends, where the port selects among the
previous, current and next frame with a fixed weight pattern per offset
in a frame (the same weights, rounded apart by an ulp); ``walk`` attacks
where ``m[i] > s[i-1]`` and holds the decisions constant under the
gradient, as the port's walk kernels do.

``graph.count`` gives ``walk_bytes`` no arguments, so the frame length is
fixed here (``FRAME_LEN``) and any other refused.  The operations a
sample are the plain compressor's without its walk, plus the pooling
(an add) and the interpolation (three); the walk's four fall on frames.
``walk_bytes`` counts the frame walk as the plain compressor counts its
walk, at frame rate: the frame energy in and the envelope out, and
under training also the frame energy and the envelope's cotangent in
and the frame energy's cotangent out.
"""

import torch

from portbench.reference import Compressor as plain
from portbench.reference.walk import ballistics

FRAME_LEN = 1024
INIT = 1.0  # the frame walk's initial state
# the one compressor of this module; also the class's defaults, for the
# arguments a configuration leaves out
ARGS = {"frame_len": FRAME_LEN, "gain_smoother": None, "gain_smooth_in_log": False,
        "knee": "quadratic"}
# energy 4, pooling 1, interpolation 3, log and offset 3, knee 5, exp 1, the gain on 2 channels
FLOPS_PER_SAMPLE = 4 + 1 + 3 + 3 + 5 + 1 + 2
FLOPS_PER_FRAME = 4  # the walk: subtract, compare, multiply, add


def _check(args):
    if {**ARGS, **args} != ARGS:
        raise NotImplementedError(f"the reference has the compressor of {ARGS} only, not {args}")


def frames(length):
    return -(-length // FRAME_LEN)


def parameter_size(args):
    _check(args)
    return {"log_threshold": (1,), "log_ratio": (1,), "log_knee": (1,), "z_alpha_pre": (2,)}


def pool(energy):
    """``(N, L)`` energy -> ``(N, frames)`` frame means, the last frame
    zero-padded."""
    n, length = energy.shape
    padded = torch.nn.functional.pad(energy, (0, frames(length) * FRAME_LEN - length))
    return padded.reshape(n, -1, FRAME_LEN).sum(-1) / FRAME_LEN


def upsample(s, length):
    """``(N, frames)`` frame values -> ``(N, length)``: linear between
    frame centres, flat outside them."""
    pos = (torch.arange(length, dtype=s.dtype, device=s.device) + 0.5) / FRAME_LEN - 0.5
    k = torch.floor(pos)
    frac = pos - k
    last = s.shape[-1] - 1
    lo = torch.clamp(k, 0, last).long()
    hi = torch.clamp(k + 1, 0, last).long()
    return s[:, lo] * (1.0 - frac) + s[:, hi] * frac


def envelope(energy, z_alpha_pre):
    ts = torch.sigmoid(z_alpha_pre)
    s = ballistics(pool(energy), ts[:, 0], ts[:, 1], torch.full_like(ts[:, 0], INIT))
    return upsample(s, energy.shape[-1])


def render(x, p, args, ctx):
    _check(args)
    env = envelope(torch.mean(x * x, dim=-2), p["z_alpha_pre"])
    log_gain = plain.knee(torch.log(env + plain.EPS), p["log_threshold"] - 6.0, p["log_ratio"],
                          p["log_knee"])
    return torch.exp(log_gain)[:, None, :] * x


def flops(rows, channels, length, args):
    return rows * (length * FLOPS_PER_SAMPLE + frames(length) * FLOPS_PER_FRAME)


def walk_bytes(rows, length, train):
    return plain.walk_bytes(rows, frames(length), train)
