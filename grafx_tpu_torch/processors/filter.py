"""Cookbook peaking and shelving biquads.

The port of the part of :mod:`grafx_tpu.processors.filter` that the
equalizers use: the gain-equipped RBJ-cookbook filters
(reference: src/grafx/processors/filter.py:559-754) and the LTI-fusion
and streaming capabilities of biquad processors.  Every filter reduces
to elementwise coefficient math followed by the exact
:class:`~grafx_tpu_torch.processors.core.iir.IIRFilter`.
"""

import math

import torch
from torch import nn

from grafx_tpu_torch.processors.core.iir import EXACT_BACKENDS, IIRFilter

PI = math.pi
ALPHA_SCALE = 0.5


class _IIRStreamMixin:
    """Streaming and LTI-fusion contracts for processors that reduce to
    ``compute_coefficients(**params) -> (Bs, As, post_gain)`` followed by
    the exact IIR backend: build the kernels once at stream start and
    carry the filter state across blocks (render/streaming.py); expose the
    coefficients as a fusion capability (render/fuse.py)."""

    def stream_init(self, num_channels, block_len, **params):
        Bs, As, gain = self.compute_coefficients(**params)
        cache = self.biquad.precompute(Bs, As)
        state = self.biquad.stream_zero_state(cache, num_channels, block_len)
        return state, {"iir": cache, "gain": gain}

    def stream_step(self, x, state, cache):
        y, state = self.biquad.stream(x, state, cache["iir"])
        if cache["gain"] is not None:
            y = cache["gain"][..., None] * y
        return y, state

    @property
    def lti_kind(self):
        """``"iir"`` (exact cascades concatenate), or ``None`` for
        midside channel handling, which is not channel-diagonal."""
        if getattr(self, "processor_channel", None) == "midside":
            return None
        return "iir" if self.biquad.backend in EXACT_BACKENDS else None

    def biquad_kernel(self, **params):
        """``(Bs, As, post_gain)`` with shapes ``(B, C_h, K, 3)`` /
        optional ``(B, C_g)``: a serial chain of such processors equals
        ONE cascade of the concatenated stacks times the product of the
        post-gains."""
        return self.compute_coefficients(**params)


class BaseParametricEqualizerFilter(_IIRStreamMixin, nn.Module):
    """Gain-equipped cookbook biquad base (reference: filter.py:559-616)."""

    def __init__(self, num_filters=1, **backend_kwargs):
        super().__init__()
        self.num_filters = num_filters
        self.biquad = IIRFilter(order=2, **backend_kwargs)

    def compute_coefficients(self, w0, q_inv, log_gain):
        w0, q_inv, A = self.filter_parameter_activations(w0, q_inv, log_gain)
        cos_w0, alpha = self.compute_common_filter_parameters(w0, q_inv)
        Bs, As = self.get_biquad_coefficients(cos_w0, alpha, A)
        return Bs[:, None], As[:, None], None

    def forward(self, input_signals, w0, q_inv, log_gain):
        Bs, As, _ = self.compute_coefficients(w0, q_inv, log_gain)
        return self.biquad(input_signals, Bs, As)

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha, A):
        raise NotImplementedError

    @staticmethod
    def filter_parameter_activations(w0, q_inv, log_gain):
        return PI * torch.sigmoid(w0), torch.exp(q_inv), torch.exp(log_gain)

    @staticmethod
    def compute_common_filter_parameters(w0, q_inv):
        cos_w0 = torch.cos(w0)
        alpha = torch.sin(w0) * q_inv * ALPHA_SCALE
        return cos_w0, alpha

    def parameter_size(self):
        return {
            "w0": self.num_filters,
            "q_inv": self.num_filters,
            "log_gain": self.num_filters,
        }


class PeakingFilter(BaseParametricEqualizerFilter):
    """Second-order peaking filter (reference: filter.py:619-656)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha, A):
        alpha_A = alpha * A
        alpha_div_A = alpha / A
        b1 = -2 * cos_w0
        Bs = torch.stack([1 + alpha_A, b1, 1 - alpha_A], -1)
        As = torch.stack([1 + alpha_div_A, b1, 1 - alpha_div_A], -1)
        return Bs, As


class LowShelf(BaseParametricEqualizerFilter):
    """Second-order low-shelf filter (reference: filter.py:659-705)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha, A):
        A_p_1, A_m_1 = A + 1, A - 1
        A_p_1_cos = A_p_1 * cos_w0
        A_m_1_cos = A_m_1 * cos_w0
        two_sqrtA_alpha = 2 * torch.sqrt(A) * alpha

        b0 = A * (A_p_1 - A_m_1_cos + two_sqrtA_alpha)
        b1 = 2 * A * (A_m_1 - A_p_1_cos)
        b2 = A * (A_p_1 - A_m_1_cos - two_sqrtA_alpha)
        a0 = A_p_1 + A_m_1_cos + two_sqrtA_alpha
        a1 = -2 * (A_m_1 + A_p_1_cos)
        a2 = A_p_1 + A_m_1_cos - two_sqrtA_alpha
        return torch.stack([b0, b1, b2], -1), torch.stack([a0, a1, a2], -1)


class HighShelf(BaseParametricEqualizerFilter):
    """Second-order high-shelf filter (reference: filter.py:708-754)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha, A):
        A_p_1, A_m_1 = A + 1, A - 1
        A_p_1_cos = A_p_1 * cos_w0
        A_m_1_cos = A_m_1 * cos_w0
        two_sqrtA_alpha = 2 * torch.sqrt(A) * alpha

        b0 = A * (A_p_1 + A_m_1_cos + two_sqrtA_alpha)
        b1 = -2 * A * (A_m_1 + A_p_1_cos)
        b2 = A * (A_p_1 + A_m_1_cos - two_sqrtA_alpha)
        a0 = A_p_1 - A_m_1_cos + two_sqrtA_alpha
        a1 = 2 * (A_m_1 - A_p_1_cos)
        a2 = A_p_1 - A_m_1_cos - two_sqrtA_alpha
        return torch.stack([b0, b1, b2], -1), torch.stack([a0, a1, a2], -1)
