"""DSP cores shared across the processor library."""

from grafx_tpu_torch.ops.fftconv import compute_pad_len
from grafx_tpu_torch.ops.stft import get_window
from grafx_tpu_torch.processors.core.convolution import FIRConvolution, convolve
from grafx_tpu_torch.processors.core.delay import SurrogateDelay, normalized_gradient
from grafx_tpu_torch.processors.core.envelope import Ballistics, TruncatedOnePoleIIRFilter
from grafx_tpu_torch.processors.core.fft_filterbank import TriangularFilterBank
from grafx_tpu_torch.processors.core.fir import (
    ZeroPhaseFIR,
    ZeroPhaseFilterBankFIR,
    log_magnitude_to_zerophase_fir,
)
from grafx_tpu_torch.processors.core.geq import GraphicEqualizerBiquad
from grafx_tpu_torch.processors.core.iir import IIRFilter
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.noise import (
    apply_linkwitz_riley,
    get_filtered_noise,
    octave_band_filterbank,
)
from grafx_tpu_torch.processors.core.scale import (
    bark_to_hz,
    from_scale,
    hz_to_bark,
    hz_to_log,
    hz_to_mel,
    log_to_hz,
    mel_to_hz,
    to_scale,
)
from grafx_tpu_torch.processors.core.utils import normalize_impulse, rms_difference

__all__ = [
    "Ballistics",
    "FIRConvolution",
    "GraphicEqualizerBiquad",
    "IIRFilter",
    "SurrogateDelay",
    "TriangularFilterBank",
    "TruncatedOnePoleIIRFilter",
    "ZeroPhaseFIR",
    "ZeroPhaseFilterBankFIR",
    "apply_linkwitz_riley",
    "bark_to_hz",
    "compute_pad_len",
    "convolve",
    "from_scale",
    "get_filtered_noise",
    "get_window",
    "hz_to_bark",
    "hz_to_log",
    "hz_to_mel",
    "log_to_hz",
    "log_magnitude_to_zerophase_fir",
    "lr_to_ms",
    "mel_to_hz",
    "ms_to_lr",
    "normalize_impulse",
    "normalized_gradient",
    "octave_band_filterbank",
    "rms_difference",
    "to_scale",
]
