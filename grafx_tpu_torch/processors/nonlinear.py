"""Memoryless nonlinear distortions (the port of
:mod:`grafx_tpu.processors.nonlinear`; reference:
src/grafx/processors/nonlinear.py:6-413): elementwise tensor ops."""

import torch
from torch import nn


class TanhDistortion(nn.Module):
    """Tanh clipper with optional pre/post gain, bias, and DC removal."""

    def __init__(
        self,
        pre_post_gain=True,
        inverse_post_gain=True,
        remove_dc=False,
        use_bias=False,
    ):
        super().__init__()
        self.pre_post_gain = pre_post_gain
        self.inverse_post_gain = inverse_post_gain
        self.remove_dc = remove_dc
        self.use_bias = use_bias

    def forward(self, input_signals, log_pre_gain=None, log_post_gain=None, bias=None):
        if self.remove_dc:
            input_signals = input_signals - input_signals.mean(-1, keepdim=True)
        if self.pre_post_gain:
            pre_gain = torch.exp(log_pre_gain)[..., None]
            input_signals = input_signals * pre_gain
        if self.use_bias:
            bias = bias[..., None]
            out = torch.tanh(input_signals + bias) - torch.tanh(bias)
        else:
            out = torch.tanh(input_signals)
        if self.pre_post_gain:
            post_gain = (
                1.0 / pre_gain
                if self.inverse_post_gain
                else torch.exp(log_post_gain)[..., None]
            )
            out = out * post_gain
        return out

    def parameter_size(self):
        size = {}
        if self.pre_post_gain:
            size["log_pre_gain"] = 1
            if not self.inverse_post_gain:
                size["log_post_gain"] = 1
        if self.use_bias:
            size["bias"] = 1
        return size


class PiecewiseTanhDistortion(nn.Module):
    """Three-segment tanh with hardness and threshold controls (reference:
    nonlinear.py:115-234)."""

    def __init__(self, pre_post_gain=True, inverse_post_gain=True, remove_dc=False):
        super().__init__()
        self.pre_post_gain = pre_post_gain
        self.inverse_post_gain = inverse_post_gain
        self.remove_dc = remove_dc

    def forward(self, input_signals, log_hardness, z_threshold, log_pre_gain=None,
                log_post_gain=None):
        if self.remove_dc:
            input_signals = input_signals - input_signals.mean(-1, keepdim=True)
        if self.pre_post_gain:
            pre_gain = torch.exp(log_pre_gain)[..., None]
            input_signals = input_signals * pre_gain
        out = self.apply_distortion(
            input_signals, torch.exp(log_hardness), torch.sigmoid(z_threshold)
        )
        if self.pre_post_gain:
            post_gain = (
                1.0 / pre_gain if self.inverse_post_gain else torch.exp(log_post_gain)[..., None]
            )
            out = out * post_gain
        return out

    @staticmethod
    def apply_distortion(input_signals, hardness, threshold):
        hardness = hardness[..., None, :]
        threshold = threshold[..., None, :]
        kn, kp = threshold[..., 0:1], threshold[..., 1:2]
        gp, gn = hardness[..., 0:1], hardness[..., 1:2]
        ap, an = (1 - torch.tanh(kp)) / gp, (1 - torch.tanh(kn)) / gn
        bp, bn = torch.tanh(kp), -torch.tanh(kn)
        above = ap * torch.tanh(gp * (input_signals - kp)) + bp
        middle = torch.tanh(input_signals)
        below = an * torch.tanh(gn * (input_signals + kn)) + bn
        return torch.where(
            input_signals > kp, above, torch.where(input_signals < -kn, below, middle)
        )

    def parameter_size(self):
        size = {"log_hardness": 2, "z_threshold": 2}
        if self.pre_post_gain:
            size["log_pre_gain"] = 1
            if not self.inverse_post_gain:
                size["log_post_gain"] = 1
        return size


class _BasisDistortion(nn.Module):
    """A weighted sum of ``max_order`` basis functions of the signal,
    weights ``tanh(basis_weights)``, after an optional pre-gain.  The sum
    accumulates term by term, which is ``grafx_tpu``'s einsum over a
    stacked ``(B, C, L, K)`` basis to float32 round-off, without building
    that tensor (713 MB at 68 x 2 x 2^17 x 10, and its copy along the
    last dimension took 3.4 of the FDN console's 10.9 busy ms a request on
    the H100, PERF.md)."""

    def __init__(self, max_order=10, pre_gain=True, remove_dc=False, use_tanh=False):
        super().__init__()
        if max_order <= 1:
            raise ValueError(f"max_order must exceed 1, got {max_order}")
        self.max_order = max_order
        self.pre_gain = pre_gain
        self.remove_dc = remove_dc
        self.use_tanh = use_tanh

    def forward(self, input_signals, basis_weights, log_pre_gain=None):
        if self.remove_dc:
            input_signals = input_signals - input_signals.mean(-1, keepdim=True)
        if self.pre_gain:
            input_signals = input_signals * torch.exp(log_pre_gain)[..., None]
        return self._weighted_basis(input_signals, torch.tanh(basis_weights), self.use_tanh)

    @classmethod
    def _weighted_basis(cls, input_signals, basis_weights, use_tanh):
        """``sum_k basis_weights[:, k] * basis_k(input_signals)``, the
        weights as given, term by term."""
        weights = basis_weights[..., None, None]  # (B, K, 1, 1)
        out = 0.0
        for k, term in enumerate(cls.basis(input_signals, basis_weights.shape[-1])):
            if use_tanh:
                term = torch.tanh(term)
            out = out + weights[:, k] * term
        return out

    def parameter_size(self):
        size = {"basis_weights": self.max_order}
        if self.pre_gain:
            size["log_pre_gain"] = 1
        return size


class PowerDistortion(_BasisDistortion):
    """Polynomial distortion, the powers ``x^k`` for k < ``max_order``
    (reference: nonlinear.py:237-312).  At ``x = 0`` the gradient is that
    of the k = 0 and k = 1 terms, 0 and 1 (``torch.pow`` with a scalar
    exponent); ``grafx_tpu``'s is NaN there (jax's pow JVP forms k
    x^(k-1), 0 * inf at k = 0)."""

    @staticmethod
    def basis(x, max_order):
        for k in range(max_order):
            yield torch.pow(x, float(k))


class ChebyshevDistortion(_BasisDistortion):
    """Chebyshev-basis distortion, ``T_k(x)`` for k < ``max_order`` by the
    recurrence ``T_k = 2 x T_{k-1} - T_{k-2}`` (reference:
    nonlinear.py:315-413)."""

    @staticmethod
    def basis(x, max_order):
        prev, cur = torch.ones_like(x), x
        yield prev
        yield cur
        for _ in range(2, max_order):
            prev, cur = cur, 2 * x * cur - prev
            yield cur

    @staticmethod
    def apply_distortion(input_signals, basis_weights, use_tanh=False):
        """The Chebyshev basis of ``input_signals`` ``(B, C, L)`` weighted by
        ``basis_weights`` ``(B, K)`` as given (``forward`` passes their
        ``tanh``), each term through ``tanh`` first where ``use_tanh``
        (reference: ``grafx_tpu/processors/nonlinear.py:172``)."""
        return ChebyshevDistortion._weighted_basis(input_signals, basis_weights, use_tanh)
