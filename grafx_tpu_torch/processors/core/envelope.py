"""Envelope smoothers: truncated one-pole IIR and attack/release ballistics.

The port of :mod:`grafx_tpu.processors.core.envelope`.  Both smoothers run
forward, differentiate and stream block by block (``stream_zero_state``
/ ``stream``): the ballistics recursion through
:func:`grafx_tpu_torch.ops.ballistics.ballistics_core` (CUDA kernels on
the card, their plain versions on the CPU; under autograd the walk with
residuals and its adjoint kernel), the one-pole through the exact
blocked :func:`~grafx_tpu_torch.ops.iir.onepole_exact` or the truncated
impulse response.  Where a compressor or gate can, its gain runs as the
fused smoother + knee kernels instead (see
:func:`grafx_tpu_torch.processors.dynamics.gain_op`);
a ``FactorizedCompressor`` smooths its frames with :class:`Ballistics`.
"""

import torch
from torch import nn

from grafx_tpu_torch.ops.ballistics import ballistics_core, ballistics_stream, walk_state
from grafx_tpu_torch.ops.fftconv import fft_convolve
from grafx_tpu_torch.ops.iir import onepole_exact


class TruncatedOnePoleIIRFilter(nn.Module):
    """One-pole energy smoother (reference: core/envelope.py:10-60).

    Args:
        iir_len: truncated IR length (the approximate backend).
        exact: the exact blocked one-pole filter
            (:func:`~grafx_tpu_torch.ops.iir.onepole_exact`) instead of
            the truncated FIR; with it, a dynamics processor maps this
            smoother onto the fused gain walk as the ``at == rt == 1 -
            alpha`` case with initial state 0.
    """

    def __init__(self, iir_len=16384, exact=False, **_ignored_backend_kwargs):
        super().__init__()
        self.iir_len = iir_len
        self.exact = exact

    @staticmethod
    def _alpha(z_alpha):
        return torch.clamp(torch.sigmoid(z_alpha), max=1.0 - 1e-5)

    def forward(self, input_signals, z_alpha):
        """Smooth ``(B, L)`` signals with per-item coefficients
        ``z_alpha`` ``(B, 1)`` (pre-sigmoid)."""
        alpha = self._alpha(z_alpha)
        if self.exact:
            smoothed = onepole_exact(input_signals, alpha[..., 0])
        else:
            h = self.compute_impulse(alpha)
            smoothed = fft_convolve(input_signals, h, mode="causal", pad_mode="pow2")
        return torch.relu(smoothed)

    def compute_impulse(self, alpha):
        n = torch.arange(self.iir_len, dtype=alpha.dtype, device=alpha.device)[None, :]
        return (1.0 - alpha) * torch.exp(n * torch.log(alpha))

    # -- streaming -----------------------------------------------------

    def stream_zero_state(self, batch_size, device=None):
        """Carried state (the previous raw output sample) for block-wise
        streaming; the exact backend only (the truncated FIR has no
        compact state)."""
        if not self.exact:
            raise NotImplementedError(
                "streaming requires the exact one-pole backend"
                " (TruncatedOnePoleIIRFilter(exact=True))."
            )
        return torch.zeros(batch_size, device=device)

    def stream(self, input_signals, state, z_alpha):
        """One block: ``(relu(y), y[:, -1])``; the state is the raw last
        sample."""
        y, state = onepole_exact(
            input_signals, self._alpha(z_alpha)[..., 0], state_in=state, return_state=True
        )
        return torch.relu(y), state


class Ballistics(nn.Module):
    """Attack/release one-pole smoother (reference:
    core/envelope.py:63-101): ``y[n]`` follows ``u[n]`` with the attack
    coefficient when ``u[n] > y[n-1]`` and the release one otherwise;
    ``z_alpha`` is ``(B, 2)`` pre-sigmoid attack and release
    coefficients."""

    def forward(self, input_signals, z_alpha):
        ts = torch.sigmoid(z_alpha)
        zi = torch.ones(
            input_signals.shape[0], dtype=input_signals.dtype, device=input_signals.device
        )
        return ballistics_core(input_signals, zi, ts[..., 0], ts[..., 1])

    # -- streaming -----------------------------------------------------

    def stream_zero_state(self, batch_size, device=None):
        """Initial state: the envelope 1 (``forward``'s ``zi``) and no
        link begun (:func:`~grafx_tpu_torch.ops.ballistics.walk_state`)."""
        return walk_state(torch.ones(batch_size, device=device))

    def stream(self, input_signals, state, z_alpha):
        """One block: ``(y, new_state)``
        (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_stream`)."""
        ts = torch.sigmoid(z_alpha)
        return ballistics_stream(input_signals, state, ts[..., 0], ts[..., 1])
