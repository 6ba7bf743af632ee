"""Filter processors: FIR, biquad variants, SVF and RBJ-cookbook filters.

The port of :mod:`grafx_tpu.processors.filter` (reference:
src/grafx/processors/filter.py:20-754).  Every biquad filter reduces to
elementwise coefficient math followed by the
:class:`~grafx_tpu_torch.processors.core.iir.IIRFilter` backend, the
frequency-sampled ``"fsm"`` by default or the exact ``"exact"``; each
streams block by block and joins LTI fusion (render/fuse.py).  The
reference's ``FIRFilter`` constructor bug (reading
``self.processor_channel`` before assignment, filter.py:39) is fixed, as
in ``grafx_tpu``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch.ops.fftconv import fft_convolve_stream
from grafx_tpu_torch.ops.iir import iir_fsm_fir
from grafx_tpu_torch.processors.core.convolution import FIRConvolution
from grafx_tpu_torch.processors.core.iir import EXACT_BACKENDS, IIRFilter
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.utils import normalize_impulse

PI = math.pi
HALF_PI = math.pi / 2
TWOR_SCALE = 1 / math.log(2)
ALPHA_SCALE = 0.5


class _IIRStreamMixin:
    """Streaming and LTI-fusion contracts for processors that reduce to
    ``compute_coefficients(**params) -> (Bs, As, post_gain)`` followed by
    the IIRFilter backend: build the kernels once at stream start and
    carry the filter state across blocks (render/streaming.py); expose the
    coefficients, or the fsm backend's own FIR, as a fusion capability
    (render/fuse.py)."""

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
        """``"iir"`` (exact backend: cascades concatenate), ``"fir"`` (fsm
        backend: the FIR approximations convolve), or ``None`` (midside
        channel handling is not channel-diagonal; the scan backend is a
        test oracle)."""
        if getattr(self, "processor_channel", None) == "midside":
            return None
        if self.biquad.backend == "fsm":
            return "fir"
        return "iir" if self.biquad.backend in EXACT_BACKENDS else None

    def biquad_kernel(self, **params):
        """IIR-LTI capability: ``(Bs, As, post_gain)`` with shapes
        ``(B, C_h, K, 3)`` / optional ``(B, C_g)``: a serial chain of such
        processors equals ONE cascade of the concatenated stacks times the
        product of the post-gains.  Exact backends only (use
        :meth:`fir_kernel` with fsm)."""
        if self.biquad.backend not in EXACT_BACKENDS:
            raise ValueError(
                "biquad_kernel requires an exact IIR backend, got"
                f" {self.biquad.backend!r}"
            )
        return self.compute_coefficients(**params)

    def fir_kernel(self, **params):
        """FIR-LTI capability of the fsm backend: this member's own
        frequency-sampled FIR (times its post-gain), shift 0.  Convolving
        members' FIRs equals applying them in sequence (both are causal
        convolutions), so fusion keeps the fsm approximation exactly."""
        if self.biquad.backend != "fsm":
            raise ValueError(
                "fir_kernel is the fsm-backend capability; backend is"
                f" {self.biquad.backend!r} (use biquad_kernel)"
            )
        Bs, As, gain = self.compute_coefficients(**params)
        h = iir_fsm_fir(Bs, As, self.biquad.fsm_fir_len)
        if gain is not None:
            h = h * gain[..., None]
        return h, 0, None


class FIRFilter(nn.Module):
    """Learnable time-domain FIR (tanh-squashed, impulse-normalized) with
    mono/stereo/midside channel handling (reference: filter.py:20-84)."""

    def __init__(self, fir_len=1023, processor_channel="mono", **backend_kwargs):
        super().__init__()
        self.fir_len = fir_len
        self.processor_channel = processor_channel
        self.conv = FIRConvolution(mode="causal", **backend_kwargs)
        match processor_channel:
            case "midside" | "stereo":
                self.num_channels = 2
            case "mono":
                self.num_channels = 1
            case _:
                raise ValueError(f"Unknown channel type: {processor_channel}")

    def forward(self, input_signals, fir):
        fir = normalize_impulse(torch.tanh(fir))
        if self.processor_channel == "midside":
            return ms_to_lr(self.conv(lr_to_ms(input_signals), fir))
        return self.conv(input_signals, fir)

    def fir_kernel(self, fir):
        """FIR-LTI capability (render/fuse.py; channel-diagonal modes)."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside FIR is not channel-diagonal")
        return normalize_impulse(torch.tanh(fir)), 0, None

    @property
    def lti_kind(self):
        return None if self.processor_channel == "midside" else "fir"

    # -- streaming: the convolution's overlap-add tail (``grafx_tpu``'s
    # FIRFilter has no stream contract and would be called per block) ---

    def stream_init(self, num_channels, block_len, fir):
        h = normalize_impulse(torch.tanh(fir))
        C = max(num_channels, h.shape[1])
        tail = h.new_zeros((h.shape[0], C, h.shape[-1] - 1))
        return tail, {"h": h, "ms": self.processor_channel == "midside"}

    def stream_step(self, x, state, cache):
        if cache["ms"]:
            y, state = fft_convolve_stream(lr_to_ms(x), cache["h"], state)
            return ms_to_lr(y), state
        return fft_convolve_stream(x, cache["h"], state)

    def parameter_size(self):
        return {"fir": (self.num_channels, self.fir_len)}


class BiquadFilter(_IIRStreamMixin, nn.Module):
    """Direct biquad coefficients with the coupled-tanh stability
    activation of the feedback path (reference: filter.py:87-168)."""

    def __init__(self, num_filters=1, normalized=False, **backend_kwargs):
        super().__init__()
        self.num_filters = num_filters
        self.normalized = normalized
        self.biquad = IIRFilter(order=2, **backend_kwargs)

    def compute_coefficients(self, Bs, A1_pre, A2_pre, A0=None):
        A1_act = 2.0 * torch.tanh(A1_pre)
        A1_abs = torch.abs(A1_act)
        A2_act = ((2.0 - A1_abs) * torch.tanh(A2_pre) + A1_abs) / 2.0
        As = torch.stack([torch.ones_like(A1_pre), A1_act, A2_act], dim=-1)
        if self.normalized:
            As = As * A0[..., None]
        Bs = torch.cat([Bs[:, :, :1] + 1.0, Bs[:, :, 1:]], dim=-1)
        return Bs[:, None], As[:, None], None

    def forward(self, input_signals, Bs, A1_pre, A2_pre, A0=None):
        Bs, As, _ = self.compute_coefficients(Bs, A1_pre, A2_pre, A0)
        return self.biquad(input_signals, Bs, As)

    def parameter_size(self):
        size = {
            "Bs": (self.num_filters, 3),
            "A1_pre": self.num_filters,
            "A2_pre": self.num_filters,
        }
        if self.normalized:
            size["A0"] = self.num_filters
        return size


class PoleZeroFilter(_IIRStreamMixin, nn.Module):
    """Biquads from complex poles/zeros; poles shrunk into the unit disk
    via ``tanh(|z|)/|z|`` (reference: filter.py:171-255)."""

    def __init__(self, num_filters=1, **backend_kwargs):
        super().__init__()
        self.num_filters = num_filters
        self.biquad = IIRFilter(order=2, **backend_kwargs)

    def compute_coefficients(self, log_gain, poles, zeros):
        gain = torch.exp(log_gain)
        poles = torch.complex(poles[..., 0], poles[..., 1])
        radii = torch.abs(poles)
        poles = poles * torch.tanh(radii) / (radii + 1e-5)
        zeros = torch.complex(zeros[..., 0], zeros[..., 1])
        ones = torch.ones_like(radii)
        Bs = torch.stack([ones, -2 * zeros.real, torch.square(torch.abs(zeros))], -1)
        As = torch.stack([ones, -2 * poles.real, torch.square(torch.abs(poles))], -1)
        return Bs[:, None], As[:, None], gain

    def forward(self, input_signals, log_gain, poles, zeros):
        Bs, As, gain = self.compute_coefficients(log_gain, poles, zeros)
        return gain[..., None] * self.biquad(input_signals, Bs, As)

    def parameter_size(self):
        return {
            "log_gain": 1,
            "poles": (self.num_filters, 2),
            "zeros": (self.num_filters, 2),
        }


class StateVariableFilter(_IIRStreamMixin, nn.Module):
    """SVF-parameterized biquads (reference: filter.py:258-338)."""

    def __init__(self, num_filters=1, **backend_kwargs):
        super().__init__()
        self.num_filters = num_filters
        self.biquad = IIRFilter(order=2, **backend_kwargs)

    def compute_coefficients(self, twoR, G, c_hp, c_bp, c_lp):
        G = torch.tan(HALF_PI * torch.sigmoid(G))
        twoR = TWOR_SCALE * F.softplus(twoR) + 1e-2
        Bs, As = self.get_biquad_coefficients(twoR, G, c_hp, c_bp, c_lp)
        return Bs[:, None], As[:, None], None

    def forward(self, input_signals, twoR, G, c_hp, c_bp, c_lp):
        Bs, As, _ = self.compute_coefficients(twoR, G, c_hp, c_bp, c_lp)
        return self.biquad(input_signals, Bs, As)

    @staticmethod
    def get_biquad_coefficients(twoR, G, c_hp, c_bp, c_lp):
        G_sq = torch.square(G)
        b0 = c_hp + c_bp * G + c_lp * G_sq
        b1 = -2 * c_hp + 2 * c_lp * G_sq
        b2 = c_hp - c_bp * G + c_lp * G_sq
        a0 = 1 + G_sq + twoR * G
        a1 = 2 * G_sq - 2
        a2 = 1 + G_sq - twoR * G
        return torch.stack([b0, b1, b2], -1), torch.stack([a0, a1, a2], -1)

    def parameter_size(self):
        return {k: self.num_filters for k in ("twoR", "G", "c_hp", "c_bp", "c_lp")}


class BaseParametricFilter(_IIRStreamMixin, nn.Module):
    """RBJ-cookbook second-order filter base
    (reference: filter.py:341-390)."""

    def __init__(self, **backend_kwargs):
        super().__init__()
        self.biquad = IIRFilter(order=2, **backend_kwargs)

    def compute_coefficients(self, w0, q_inv):
        w0, q_inv = self.filter_parameter_activations(w0, q_inv)
        cos_w0, alpha = self.compute_common_filter_parameters(w0, q_inv)
        Bs, As = self.get_biquad_coefficients(cos_w0, alpha)
        return Bs[:, None], As[:, None], None

    def forward(self, input_signals, w0, q_inv):
        Bs, As, _ = self.compute_coefficients(w0, q_inv)
        return self.biquad(input_signals, Bs, As)

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        raise NotImplementedError

    @staticmethod
    def filter_parameter_activations(w0, q_inv):
        return PI * torch.sigmoid(w0), torch.exp(q_inv)

    @staticmethod
    def compute_common_filter_parameters(w0, q_inv):
        return torch.cos(w0), torch.sin(w0) * q_inv * ALPHA_SCALE

    def parameter_size(self):
        return {"w0": 1, "q_inv": 1}


def _cookbook_denominator(cos_w0, alpha):
    return torch.stack([1 + alpha, -2 * cos_w0, 1 - alpha], -1)


class LowPassFilter(BaseParametricFilter):
    """Second-order low-pass (reference: filter.py:393-426)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        cm1 = cos_w0 - 1
        b0 = cm1 / 2
        return torch.stack([b0, cm1, b0], -1), _cookbook_denominator(cos_w0, alpha)


class HighPassFilter(BaseParametricFilter):
    """Second-order high-pass (reference: filter.py:429-463)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        cp1 = 1 + cos_w0
        b0 = cp1 / 2
        return torch.stack([b0, -cp1, b0], -1), _cookbook_denominator(cos_w0, alpha)


class BandPassFilter(BaseParametricFilter):
    """Second-order band-pass (reference: filter.py:466-495)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        Bs = torch.stack([alpha, torch.zeros_like(alpha), -alpha], -1)
        return Bs, _cookbook_denominator(cos_w0, alpha)


class BandRejectFilter(BaseParametricFilter):
    """Second-order band-reject (notch) (reference: filter.py:498-527)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        ones = torch.ones_like(cos_w0)
        Bs = torch.stack([ones, -2 * cos_w0, ones], -1)
        return Bs, _cookbook_denominator(cos_w0, alpha)


class AllPassFilter(BaseParametricFilter):
    """Second-order all-pass (reference: filter.py:530-556)."""

    @staticmethod
    def get_biquad_coefficients(cos_w0, alpha):
        a0, a1, a2 = 1 + alpha, -2 * cos_w0, 1 - alpha
        return torch.stack([a2, a1, a0], -1), torch.stack([a0, a1, a2], -1)


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
