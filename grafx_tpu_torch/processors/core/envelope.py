"""Envelope smoothers: truncated one-pole IIR and attack/release ballistics.

The port of :mod:`grafx_tpu.processors.core.envelope`.  On the serving
path these smoothers are read for their type and parameters only: the
compressor and gate gains run as the fused smoother + knee kernels of
:mod:`grafx_tpu_torch.ops.ballistics` (see ``Compressor.gain_from_energy``
and ``render.fuse.FusedDynamicsChain``).  Calling a smoother on its own
needs the plain ballistics kernel or the exact one-pole filter, which are
still to be ported (ROADMAP.md, queue 2 kernel 7 and ``onepole_exact``).
"""

from torch import nn


class TruncatedOnePoleIIRFilter(nn.Module):
    """One-pole energy smoother (reference: core/envelope.py:10-60).

    Args:
        iir_len: truncated IR length (the approximate backend).
        exact: the exact one-pole filter; with it, a dynamics processor
            maps this smoother onto the fused gain walk as the
            ``at == rt == 1 - alpha`` case with initial state 0.
    """

    def __init__(self, iir_len=16384, exact=False):
        super().__init__()
        self.iir_len = iir_len
        self.exact = exact

    def forward(self, input_signals, z_alpha):
        raise NotImplementedError(
            "the stand-alone one-pole smoother (onepole_exact / truncated"
            " FIR) is not ported yet (ROADMAP.md, queue 1)."
        )


class Ballistics(nn.Module):
    """Attack/release one-pole smoother (reference:
    core/envelope.py:63-101); ``z_alpha`` is ``(B, 2)`` pre-sigmoid attack
    and release coefficients."""

    def forward(self, input_signals, z_alpha):
        raise NotImplementedError(
            "the stand-alone ballistics recursion (_kernel, queue 2"
            " kernel 7) is not ported yet (ROADMAP.md)."
        )
