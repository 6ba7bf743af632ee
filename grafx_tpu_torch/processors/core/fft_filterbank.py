"""Triangular filterbank on bark/mel/linear/log scales (the port of
:mod:`grafx_tpu.processors.core.fft_filterbank`; reference:
src/grafx/processors/core/fft_filterbank.py:9-154).  The matrix is built
in numpy at init and held as a buffer; applying it is one matmul."""

import warnings

import numpy as np
import torch
from torch import nn

from grafx_tpu_torch.processors.core.scale import from_scale, to_scale

SCALES = (
    "bark_traunmuller",
    "bark_schroeder",
    "bark_wang",
    "mel_htk",
    "mel_slaney",
    "linear",
    "log",
)


class TriangularFilterBank(nn.Module):
    """Synthesis (expand filterbank energies to FFT bins) and analysis
    (normalized pooling) by matmuls.

    Args:
        num_frequency_bins: linear FFT bins ``F``.
        num_filters: filterbank size ``F_fb``.
        scale: frequency scale name (one of :data:`SCALES`).
        f_min / f_max / sr: frequency range.
        low_half_triangle: attach the remaining low-frequency residual row.
    """

    def __init__(
        self,
        num_frequency_bins,
        num_filters=50,
        scale="bark_traunmuller",
        f_min=40,
        f_max=None,
        sr=44100,
        low_half_triangle=True,
    ):
        super().__init__()
        if f_max is not None and f_max > sr // 2:
            warnings.warn(
                f"`f_max` ({f_max}) is higher than the Nyquist frequency"
                f" ({sr // 2}); clamping."
            )
            f_max = sr // 2
        fb = self.compute_matrix(
            num_frequency_bins=num_frequency_bins,
            num_filters=num_filters,
            scale=scale,
            f_min=f_min,
            f_max=f_max,
            sr=sr,
            low_half_triangle=low_half_triangle,
        )
        self.num_filters = num_filters
        fb_norm = fb / np.maximum(fb.sum(0, keepdims=True), 1e-12)
        # (F_fb, F) for synthesis, (F, F_fb) for analysis
        self.register_buffer(
            "filterbank", torch.as_tensor(fb.T, dtype=torch.float32), persistent=False
        )
        self.register_buffer(
            "filterbank_normalized",
            torch.as_tensor(fb_norm, dtype=torch.float32),
            persistent=False,
        )

    def forward(self, energy, mode="synthesis"):
        """Apply the filterbank to ``(..., F_fb)`` (synthesis) or
        ``(..., F)`` (analysis) energies."""
        match mode:
            case "analysis":
                return torch.matmul(energy, self.filterbank_normalized)
            case "synthesis":
                return torch.matmul(energy, self.filterbank)
            case _:
                raise ValueError(f"Unsupported mode: {mode}")

    @staticmethod
    def compute_matrix(
        num_frequency_bins, num_filters, scale, f_min, f_max, sr, low_half_triangle
    ):
        """The ``(F, F_fb)`` triangular filterbank matrix (numpy)."""
        if scale not in SCALES:
            raise ValueError(f"Unsupported scale: {scale}; expected one of {SCALES}")
        if f_max is None:
            f_max = sr // 2
        if low_half_triangle:
            num_filters -= 1

        all_freqs = np.linspace(0, sr // 2, num_frequency_bins)
        s_min, s_max = to_scale(f_min, scale), to_scale(f_max, scale)
        s_pts = np.linspace(s_min, s_max, num_filters + 2)
        f_pts = from_scale(s_pts, scale)

        f_diff = f_pts[1:] - f_pts[:-1]
        slopes = f_pts[None, :] - all_freqs[:, None]
        down_slopes = -slopes[:, :-2] / f_diff[:-1]
        up_slopes = slopes[:, 2:] / f_diff[1:]
        fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

        if low_half_triangle:
            remaining = 1.0 - fb.sum(-1)
            fb = np.concatenate([remaining[:, None], fb], axis=-1)

        if (fb.max(axis=0) == 0.0).any():
            warnings.warn(
                "At least one filterbank row is all-zero; `num_filters` may"
                " be too high or `num_frequency_bins` too low."
            )
        return fb
