"""Equalizers: zero-phase FIR, parametric and graphic (the port of
:mod:`grafx_tpu.processors.eq`; reference: src/grafx/processors/
eq.py:25-436)."""

import torch
from torch import nn

from grafx_tpu_torch.processors.core.convolution import convolve
from grafx_tpu_torch.processors.core.fir import ZeroPhaseFIR, ZeroPhaseFilterBankFIR
from grafx_tpu_torch.processors.core.geq import GraphicEqualizerBiquad
from grafx_tpu_torch.processors.core.iir import IIRFilter
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.filter import (
    BaseParametricEqualizerFilter,
    HighShelf,
    LowShelf,
    PeakingFilter,
    _IIRStreamMixin,
)


class _ZeroPhaseMixin:
    """A zero-phase FIR needs ``L_h // 2`` samples of lookahead, which a
    causal block stream cannot give."""

    def stream_init(self, num_channels, block_len, **params):
        raise NotImplementedError(
            f"{type(self).__name__} is zero-phase (non-causal); block-wise"
            " streaming supports causal processors only."
        )


class ZeroPhaseFIREqualizer(_ZeroPhaseMixin, nn.Module):
    """Single-channel zero-phase FIR EQ from a log-magnitude response
    (reference: eq.py:25-79; deprecated in favor of
    :class:`NewZeroPhaseFIREqualizer`)."""

    def __init__(self, num_magnitude_bins=1024):
        super().__init__()
        self.num_magnitude_bins = num_magnitude_bins
        self.fir = ZeroPhaseFIR(num_magnitude_bins)

    def forward(self, input_signals, log_magnitude):
        return convolve(input_signals, self.fir(log_magnitude)[:, None, :], mode="zerophase")

    def fir_kernel(self, log_magnitude):
        """FIR-LTI capability (render/fuse.py): ``(h, shift, aux)`` such
        that this processor equals a shift-cropped causal convolution."""
        fir = self.fir(log_magnitude)[:, None, :]
        return fir, fir.shape[-1] // 2, None

    def parameter_size(self):
        return {"log_magnitude": self.num_magnitude_bins}


class NewZeroPhaseFIREqualizer(_ZeroPhaseMixin, nn.Module):
    """Zero-phase FIR EQ with channel modes and an optional triangular
    filterbank parameterization (reference: eq.py:82-214)."""

    def __init__(
        self,
        num_frequency_bins=1024,
        processor_channel="mono",
        use_filterbank=False,
        filterbank_kwargs=None,
        window="hann",
        window_kwargs=None,
        eps=1e-7,
        **_ignored,
    ):
        super().__init__()
        if processor_channel not in ("mono", "stereo", "midside"):
            raise ValueError(f"Invalid processor_channel: {processor_channel}")
        self.num_frequency_bins = num_frequency_bins
        self.processor_channel = processor_channel
        self.use_filterbank = use_filterbank
        self.fir = ZeroPhaseFilterBankFIR(
            num_frequency_bins=num_frequency_bins,
            use_filterbank=use_filterbank,
            filterbank_kwargs=filterbank_kwargs or {},
            window=window,
            window_kwargs=window_kwargs or {},
            eps=eps,
        )

    def forward(self, input_signals, log_magnitude):
        fir = self.fir(log_magnitude)
        if self.processor_channel == "midside":
            return ms_to_lr(convolve(lr_to_ms(input_signals), fir, mode="zerophase"))
        return convolve(input_signals, fir, mode="zerophase")

    def fir_kernel(self, log_magnitude):
        """FIR-LTI capability (channel-diagonal modes only: midside applies
        distinct M/S filters, a 2 x 2 matrix convolution in L/R)."""
        if self.processor_channel == "midside":
            raise NotImplementedError(
                "midside zero-phase EQ is not channel-diagonal; not fusable"
            )
        fir = self.fir(log_magnitude)
        return fir, fir.shape[-1] // 2, None

    def parameter_size(self):
        n_bins = (
            self.fir.filterbank.num_filters if self.use_filterbank else self.num_frequency_bins
        )
        n_channels = 1 if self.processor_channel == "mono" else 2
        return {"log_magnitude": (n_channels, n_bins)}


class _EqualizerStreamMixin(_IIRStreamMixin):
    """Streaming of the equalizers: their ``precompute`` cache is the
    stream cache, and midside channel handling wraps the filter."""

    def stream_init(self, num_channels, block_len, **params):
        """Streaming contract (render/streaming.py): build the biquad
        kernels once, carry the filter state across blocks."""
        cache = self.precompute(**params)
        return self.biquad.stream_zero_state(cache, num_channels, block_len), cache

    def stream_step(self, x, state, cache):
        if self.processor_channel == "midside":
            y, state = self.biquad.stream(lr_to_ms(x), state, cache)
            return ms_to_lr(y), state
        return self.biquad.stream(x, state, cache)


class ParametricEqualizer(_EqualizerStreamMixin, nn.Module):
    """Cascade of K biquads: low-shelf + peaks + high-shelf (or all
    peaks) (reference: eq.py:217-336)."""

    def __init__(
        self,
        num_filters=10,
        processor_channel="mono",
        use_shelving_filters=True,
        **backend_kwargs,
    ):
        super().__init__()
        self.num_filters = num_filters
        self.use_shelving_filters = use_shelving_filters
        self.processor_channel = processor_channel
        self.biquad = IIRFilter(order=2, **backend_kwargs)
        if processor_channel not in ("mono", "stereo", "midside"):
            raise ValueError(f"Invalid processor_channel: {processor_channel}")

    def compute_coefficients(self, w0, q_inv, log_gain):
        """Biquad stacks ``(B, C_h, K, 3)``."""
        w0, q_inv, A = BaseParametricEqualizerFilter.filter_parameter_activations(
            w0, q_inv, log_gain
        )
        cos_w0, alpha = (
            BaseParametricEqualizerFilter.compute_common_filter_parameters(w0, q_inv)
        )
        Bs, As = self.get_biquad_coefficients(cos_w0, alpha, A)
        return Bs, As, None

    def precompute(self, w0, q_inv, log_gain):
        """``precompute`` hook: coefficient activations + kernel build for
        ALL nodes of this type at once."""
        Bs, As, _ = self.compute_coefficients(w0, q_inv, log_gain)
        return self.biquad.precompute(Bs, As)

    def forward(self, input_signals, w0=None, q_inv=None, log_gain=None, _cache=None):
        if _cache is None:
            _cache = self.precompute(w0, q_inv, log_gain)
        if self.processor_channel == "midside":
            x = lr_to_ms(input_signals)
            return ms_to_lr(self.biquad(x, cache=_cache))
        return self.biquad(input_signals, cache=_cache)

    def get_biquad_coefficients(self, cos_w0, alpha, A):
        if not self.use_shelving_filters:
            return PeakingFilter.get_biquad_coefficients(cos_w0, alpha, A)

        # first filter = low shelf, last = high shelf, middle = peaks
        def split(x):
            return x[..., :1], x[..., 1:-1], x[..., -1:]

        (c_ls, c_pk, c_hs) = split(cos_w0)
        (a_ls, a_pk, a_hs) = split(alpha)
        (A_ls, A_pk, A_hs) = split(A)
        Bs_ls, As_ls = LowShelf.get_biquad_coefficients(c_ls, a_ls, A_ls)
        Bs_pk, As_pk = PeakingFilter.get_biquad_coefficients(c_pk, a_pk, A_pk)
        Bs_hs, As_hs = HighShelf.get_biquad_coefficients(c_hs, a_hs, A_hs)
        Bs = torch.cat([Bs_ls, Bs_pk, Bs_hs], dim=-2)
        As = torch.cat([As_ls, As_pk, As_hs], dim=-2)
        return Bs, As

    def parameter_size(self):
        n_channels = 1 if self.processor_channel == "mono" else 2
        size = (n_channels, self.num_filters)
        return {k: size for k in ["w0", "q_inv", "log_gain"]}


class GraphicEqualizer(_EqualizerStreamMixin, nn.Module):
    """24-band bark / 31-band third-octave graphic EQ
    (reference: eq.py:339-436)."""

    def __init__(self, processor_channel="mono", scale="bark", sr=44100, **backend_kwargs):
        super().__init__()
        self.geq = GraphicEqualizerBiquad(scale=scale, sr=sr)
        self.biquad = IIRFilter(**backend_kwargs)
        self.processor_channel = processor_channel
        if processor_channel not in ("mono", "stereo", "midside"):
            raise ValueError(f"Invalid processor_channel: {processor_channel}")

    def compute_coefficients(self, log_gains):
        """Biquad stacks ``(B, C_h, K, 3)``."""
        Bs, As = self.geq(log_gains)
        return Bs, As, None

    def precompute(self, log_gains):
        """``precompute`` hook: band-filter design + kernel build for all
        nodes of this type at once."""
        Bs, As, _ = self.compute_coefficients(log_gains)
        return self.biquad.precompute(Bs, As)

    def forward(self, input_signals, log_gains=None, _cache=None):
        if _cache is None:
            _cache = self.precompute(log_gains)
        if self.processor_channel == "midside":
            x = lr_to_ms(input_signals)
            return ms_to_lr(self.biquad(x, cache=_cache))
        return self.biquad(input_signals, cache=_cache)

    def parameter_size(self):
        n_channels = 1 if self.processor_channel == "mono" else 2
        return {"log_gains": (n_channels, self.geq.num_bands)}
