"""Compressor whose gain is smoothed too (GRAFX's ``Compressor`` with
``energy_smoother="ballistics", gain_smoother="ballistics"``; reference
dynamics.py:355-358, :411-419): the channels' mean energy ``e``, its
ballistics walk from 1, the quadratic knee on its log against the
threshold (less 6 dB), the linear gain walked again from 1, and the
signal times that gain:

    v = walk(e; sigmoid(z_alpha_pre); 1)
    l = knee(log(v + 1e-5); log_threshold - 6, log_ratio, log_knee)
    g = walk(exp(l); sigmoid(z_alpha_post); 1)
    y = g x

``walk`` is :mod:`~portbench.reference.walk`'s recursion, which attacks
where ``u[n] > y[n-1]``; GRAFX attacks where ``u[n] >= y[n-1]``, which
differs only on a tie, where both coefficients give the same step.

The operations a sample are the plain compressor's and the gain walk's
(subtract, compare, multiply, add): the exp is the same one, taken
before the walk.  ``walk_bytes`` counts what the dynamics layer needs
from and gives to the rest of the graph, the energy in and the gain out
(under training also the energy and the gain's cotangent in and the
energy's cotangent out), as for the plain compressor: the smoothed
energy between the two walks is the layer's own and not among them.
"""

import torch

from portbench.reference import Compressor as plain
from portbench.reference.walk import ballistics

ARGS = {"energy_smoother": "ballistics", "gain_smoother": "ballistics",
        "gain_smooth_in_log": False, "knee": "quadratic"}
# the class's defaults, for the arguments a configuration leaves out
DEFAULTS = {"energy_smoother": "iir", "gain_smoother": None, "gain_smooth_in_log": False,
            "knee": "quadratic"}
FLOPS_PER_SAMPLE = plain.FLOPS_PER_SAMPLE + 4  # the gain walk: subtract, compare, multiply, add
walk_bytes = plain.walk_bytes  # the same walk layer


def _check(args):
    if {**DEFAULTS, **args} != ARGS:
        raise NotImplementedError(f"the reference has the compressor of {ARGS} only, not {args}")


def parameter_size(args):
    _check(args)
    return {"log_threshold": (1,), "log_ratio": (1,), "log_knee": (1,), "z_alpha_pre": (2,),
            "z_alpha_post": (2,)}


def render(x, p, args, ctx):
    _check(args)
    energy = torch.mean(x * x, dim=-2)
    ts = torch.sigmoid(p["z_alpha_pre"])
    one = torch.ones_like(ts[:, 0])
    env = ballistics(energy, ts[:, 0], ts[:, 1], one)
    log_gain = plain.knee(torch.log(env + plain.EPS), p["log_threshold"] - 6.0, p["log_ratio"],
                          p["log_knee"])
    tg = torch.sigmoid(p["z_alpha_post"])
    return ballistics(torch.exp(log_gain), tg[:, 0], tg[:, 1], one)[:, None, :] * x


def flops(rows, channels, length, args):
    return rows * length * FLOPS_PER_SAMPLE
