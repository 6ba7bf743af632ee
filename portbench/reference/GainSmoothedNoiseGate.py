"""Noise gate whose gain is smoothed in the log domain (GRAFX's
``NoiseGate`` with ``energy_smoother="iir_exact",
gain_smoother="ballistics", gain_smooth_in_log=True``; reference
dynamics.py:355-358, :411-419): the channels' mean energy ``e`` through
the exact one-pole from 0, the gate's quadratic knee on its log against
the threshold (less 6 dB), the log gain walked from 1, and the signal
times its exp:

    v = relu(onepole(e, min(sigmoid(z_alpha_pre[0]), 1 - 1e-5)))
    l = gate_knee(log(v + 1e-5); log_threshold - 6, log_ratio, log_knee)
    g = exp(walk(l; sigmoid(z_alpha_post); 1))
    y = g x

The log gain's walk starts from 1, as GRAFX's ``Ballistics`` starts
every walk (a gain of e at the first sample, before the walk follows the
knee).  ``walk`` attacks where ``u[n] > y[n-1]``, GRAFX where ``u[n] >=
y[n-1]``: the two differ only on a tie, where both steps are the same.

The operations a sample are the plain gate's and the gain walk's; the
exp is the same one, taken after the walk.  ``walk_bytes`` is the plain
gate's: the energy in and the gain out (and the cotangents under
training); the smoothed energy between the smoothers is not among them.
"""

import torch

from portbench.reference import NoiseGate as plain
from portbench.reference import lti
from portbench.reference.GainSmoothedCompressor import DEFAULTS
from portbench.reference.walk import ballistics

ARGS = {"energy_smoother": "iir_exact", "gain_smoother": "ballistics",
        "gain_smooth_in_log": True, "knee": "quadratic"}
FLOPS_PER_SAMPLE = plain.FLOPS_PER_SAMPLE + 4  # the gain walk: subtract, compare, multiply, add
walk_bytes = plain.walk_bytes  # the same walk layer


def _check(args):
    if {**DEFAULTS, **args} != ARGS:
        raise NotImplementedError(f"the reference has the gate of {ARGS} only, not {args}")


def parameter_size(args):
    _check(args)
    return {"log_threshold": (1,), "log_ratio": (1,), "log_knee": (1,), "z_alpha_pre": (1,),
            "z_alpha_post": (2,)}


def render(x, p, args, ctx):
    _check(args)
    energy = torch.mean(x * x, dim=-2)
    alpha = torch.clamp(torch.sigmoid(p["z_alpha_pre"][:, 0]), max=1.0 - 1e-5)
    env = torch.relu(lti.onepole(energy, alpha))
    log_gain = plain.knee(torch.log(env + plain.EPS), p["log_threshold"] - 6.0, p["log_ratio"],
                          p["log_knee"])
    tg = torch.sigmoid(p["z_alpha_post"])
    return torch.exp(ballistics(log_gain, tg[:, 0], tg[:, 1], torch.ones_like(alpha)))[:, None, :] * x


def flops(rows, channels, length, args):
    return rows * length * FLOPS_PER_SAMPLE
