"""Zero-phase FIR synthesis from log-magnitude responses (the port of
:mod:`grafx_tpu.processors.core.fir`; reference:
src/grafx/processors/core/fir.py:25-123): exp(log-magnitude) -> irfft ->
roll to the centre -> window."""

import torch
from torch import nn

from grafx_tpu_torch.ops.stft import get_window
from grafx_tpu_torch.processors.core.fft_filterbank import TriangularFilterBank


def log_magnitude_to_zerophase_fir(log_magnitude, fir_len, window=None):
    """``(..., F)`` log-magnitudes -> ``(..., fir_len)`` zero-phase FIRs."""
    ir = torch.fft.irfft(torch.exp(log_magnitude), n=fir_len)
    ir = torch.roll(ir, shifts=fir_len // 2, dims=-1)
    if window is not None:
        ir = ir * window
    return ir


def _register_window(module, window, length, **kwargs):
    """``module.window``: a buffer of the named (or given) window, or
    ``None`` for a rectangular one."""
    if window is None or isinstance(window, str):
        window = get_window(window, length, **kwargs)
    if window is None:
        module.window = None
    else:
        module.register_buffer(
            "window", torch.as_tensor(window, dtype=torch.float32), persistent=False
        )


class ZeroPhaseFIR(nn.Module):
    """Zero-phase FIR from a log-magnitude response
    (reference: core/fir.py:43-83)."""

    def __init__(self, num_magnitude_bins=1024, window="hann", **window_kwargs):
        super().__init__()
        self.num_magnitude_bins = num_magnitude_bins
        self.fir_len = 2 * num_magnitude_bins - 1
        _register_window(self, window, self.fir_len, **window_kwargs)

    def forward(self, log_magnitude):
        return log_magnitude_to_zerophase_fir(
            log_magnitude, fir_len=self.fir_len, window=self.window
        )


class ZeroPhaseFilterBankFIR(nn.Module):
    """Zero-phase FIR with an optional triangular-filterbank magnitude
    parameterization in the energy domain
    (reference: core/fir.py:86-123)."""

    def __init__(
        self,
        num_frequency_bins=1024,
        use_filterbank=False,
        filterbank_kwargs=None,
        window="hann",
        window_kwargs=None,
        eps=1e-7,
    ):
        super().__init__()
        self.num_frequency_bins = num_frequency_bins
        self.fir_len = 2 * num_frequency_bins - 1
        self.eps = eps
        self.use_filterbank = use_filterbank
        if use_filterbank:
            self.filterbank = TriangularFilterBank(
                num_frequency_bins=num_frequency_bins, **(filterbank_kwargs or {})
            )
        _register_window(self, window, self.fir_len, **(window_kwargs or {}))

    def forward(self, log_magnitude):
        magnitude = torch.exp(log_magnitude)
        if self.use_filterbank:
            energy = self.filterbank(torch.square(magnitude))
            magnitude = torch.sqrt(energy + self.eps)
        ir = torch.fft.irfft(magnitude, n=self.fir_len)
        ir = torch.roll(ir, shifts=self.fir_len // 2, dims=-1)
        if self.window is not None:
            ir = ir * self.window
        return ir
