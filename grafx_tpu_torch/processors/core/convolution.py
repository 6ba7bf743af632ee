"""FIR convolution core: a re-export of :mod:`grafx_tpu_torch.ops.fftconv`
(the port of :mod:`grafx_tpu.processors.core.convolution`)."""

from grafx_tpu_torch.ops.fftconv import FIRConvolution, compute_pad_len, fft_convolve

convolve = fft_convolve

__all__ = ["FIRConvolution", "compute_pad_len", "convolve", "fft_convolve"]
