"""Numerical ops: FFT convolution, STFT, exact IIR, fused ballistics gain."""

from grafx_tpu_torch.ops.ballistics import ballistics_gain_core, ballistics_gain_pair_core
from grafx_tpu_torch.ops.fftconv import FIRConvolution, fft_convolve
from grafx_tpu_torch.ops.iir import biquad_exact, exactness_check_db
from grafx_tpu_torch.ops.stft import hann_window, istft, stft

__all__ = [
    "FIRConvolution",
    "ballistics_gain_core",
    "ballistics_gain_pair_core",
    "biquad_exact",
    "exactness_check_db",
    "fft_convolve",
    "hann_window",
    "istft",
    "stft",
]
