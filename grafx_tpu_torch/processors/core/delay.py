"""Surrogate learnable delay line (the port of
:mod:`grafx_tpu.processors.core.delay`; reference:
src/grafx/processors/core/delay.py:16-143).

A delay is a complex sinusoid in the frequency domain whose angular
frequency ``z`` is held inside the unit disk and learned by gradient
descent: the soft FIR is ``irfft((z + 1e-7) ** k)`` for ``k = 0 .. N //
2``, computed as a complex64 power of an integer range, on every device.
Optionally the forward is the hard one-hot delay at the soft FIR's peak
(straight through, ``irs + (hard - irs).detach()``), and the gradient of
``z`` is normalized to unit magnitude.  PyTorch's complex gradient is
the conjugate of JAX's cotangent; the normalization divides by ``|g|``,
which both share, so the real gradients of the parameters agree.

The hard delay's tap is the argmax of the same soft FIR computed in
float64 (no gradient).  Where float32 resolves the peak this is
``grafx_tpu``'s tap; where the two largest taps lie closer than float32
can tell apart (a delay halfway between two taps, and nearly every delay
at small ``|z|``, whose soft FIR is almost flat) float32 picks by
rounding, which differs between packages and between the CPU and the
card, and flips the whole output.  The float64 pick is the exact one and
the same on every device.
"""

import torch
from torch import nn


class _NormalizedGradient(torch.autograd.Function):
    @staticmethod
    def forward(z):
        return z.view_as(z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g / (1e-7 + g.abs())


def normalized_gradient(z):
    """Identity forward; the backward normalizes the gradient to unit
    magnitude (reference: core/delay.py:5-13)."""
    return _NormalizedGradient.apply(z)


class SurrogateDelay(nn.Module):
    """Surrogate FIR for a learnable delay.

    Args:
        N: FIR length (max delay + 1).
        straight_through: hard one-hot delays forward, soft surrogates
            backward.
        radii_loss: return the ``(1 - |z|)^2`` regularizer that pushes
            the delays sharp.
        normalize_gradients: unit-magnitude gradients of ``z``.
    """

    def __init__(self, N, straight_through=True, radii_loss=True, normalize_gradients=True):
        super().__init__()
        self.N = N
        self.sin_N = N // 2 + 1
        self.straight_through = straight_through
        self.radii_loss = radii_loss
        self.normalize_gradients = normalize_gradients
        self.register_buffer("k", torch.arange(self.sin_N)[None, :], persistent=False)

    def forward(self, z):
        """Surrogate-delay FIRs from complex frequencies ``z`` (any shape):
        ``(irs, radii_loss)``, ``irs`` with a trailing FIR-tap dim."""
        if not z.is_complex():
            raise TypeError(f"SurrogateDelay takes complex frequencies, got {z.dtype}")
        shape = z.shape
        z = z.reshape(-1)
        loss = self.calculate_radii_loss(z)
        irs = self.soft_firs(normalized_gradient(z) if self.normalize_gradients else z)
        if self.straight_through:
            irs = self.apply_straight_through(irs, z)
        return irs.reshape(shape + (irs.shape[-1],)), loss

    def soft_firs(self, z):
        """``(M,)`` complex frequencies -> ``(M, 2 * (N // 2))`` soft FIRs."""
        mag = z.abs()
        z = z * torch.tanh(mag) / (mag + 1e-7)
        return torch.fft.irfft((z[:, None] + 1e-7) ** self.k)

    @staticmethod
    def calculate_radii_loss(z):
        return torch.sum(torch.square(1.0 - torch.tanh(z.abs())))

    @torch.no_grad()
    def onsets(self, z):
        """The hard delays' taps: the argmax of each soft FIR computed in
        float64 (module docstring)."""
        return torch.argmax(self.soft_firs(z.reshape(-1).to(torch.complex128)), dim=-1)

    @staticmethod
    def get_hard_irs(irs):
        """One-hot FIRs at the argmax of ``irs`` along the taps, detached
        (reference: ``grafx_tpu/processors/core/delay.py:93-97``).  The
        straight-through path picks its taps in float64 instead
        (:meth:`onsets`, module docstring)."""
        return torch.zeros_like(irs).scatter_(-1, irs.argmax(-1, keepdim=True), 1.0).detach()

    def apply_straight_through(self, irs, z):
        """The one-hot FIRs at ``z``'s onsets forward, ``irs``'s gradient
        backward."""
        hard = torch.zeros_like(irs).scatter_(-1, self.onsets(z)[:, None], 1.0)
        return irs + (hard - irs).detach()
