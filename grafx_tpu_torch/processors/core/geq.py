"""Graphic-equalizer biquad design (Liski et al.).

Behavioral parity with the reference ``GraphicEqualizerBiquad``
(reference: src/grafx/processors/core/geq.py:139-209) with the hardcoded
bark-24 / third-octave-31 center-frequency and bandwidth tables
(reference: core/geq.py:7-136).  The boolean-masked in-place beta update
of the reference becomes a ``torch.where`` select.
"""

import math

import numpy as np
import torch
from torch import nn

# Third-octave design (31 bands): center frequencies and bandwidths [Hz]
FC_THIRD_OCTAVE = np.array(
    [19.69, 24.80, 31.25, 39.37, 49.61, 62.50, 78.75, 99.21, 125.0, 157.5,
     198.4, 250.0, 315.0, 396.9, 500.0, 630.0, 793.7, 1000.0, 1260.0,
     1587.0, 2000.0, 2520.0, 3175.0, 4000.0, 5040.0, 6350.0, 8000.0,
     10080.0, 12700.0, 16000.0, 20160.0]
)
FB_THIRD_OCTAVE = np.array(
    [9.178, 11.56, 14.57, 18.36, 23.13, 29.14, 36.71, 46.25, 58.28, 73.43,
     92.51, 116.6, 146.9, 185.0, 233.1, 293.7, 370.0, 466.2, 587.4, 740.1,
     932.4, 1175.0, 1480.0, 1865.0, 2350.0, 2846.0, 3502.0, 4253.0, 5038.0,
     5689.0, 5573.0]
)

# Bark-scale design (24 bands)
FC_BARK = np.array(
    [50, 150, 250, 350, 450, 570, 700, 840, 1000, 1170, 1370, 1600, 1850,
     2150, 2500, 2900, 3400, 4000, 4800, 5800, 7000, 8500, 10500, 13500],
    dtype=np.float64,
)
FB_BARK = np.array(
    [133.3, 160.0, 171.4, 177.8, 214.7, 235.9, 256.7, 294.4, 315.5, 370.8,
     426.9, 466.2, 558.1, 651.0, 744.8, 926.5, 1110.0, 1467.0, 1828.0,
     2194.0, 2735.0, 3619.0, 5333.0, 6000.0]
)


class GraphicEqualizerBiquad(nn.Module):
    """Per-band peaking biquads from log-gains with the neighbor-gain
    bandwidth-correction formula.

    Args:
        scale: ``"bark"`` (24 bands) or ``"third_octave"`` (31 bands).
        sr: sample rate (bands above Nyquist are dropped).
    """

    def __init__(self, scale="bark", sr=44100):
        super().__init__()
        match scale:
            case "bark":
                fc, fB, c = FC_BARK, FB_BARK, 0.4
            case "third_octave":
                fc, fB, c = FC_THIRD_OCTAVE, FB_THIRD_OCTAVE, 0.4
            case _:
                raise ValueError(f"Unsupported scale: {scale}")

        keep = fc < sr / 2
        fc, fB = fc[keep], fB[: keep.sum()]
        wc = 2 * math.pi * fc / sr
        self.register_buffer(
            "m2_cos_wc",
            torch.as_tensor(-2 * np.cos(wc), dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "tan_B_half",
            torch.as_tensor(np.tan(math.pi * fB / sr), dtype=torch.float32),
            persistent=False,
        )
        self.c = c
        self.num_bands = len(fc)

    def forward(self, log_gains):
        """Compute biquad coefficients from ``(..., num_bands)`` log-gains.

        Returns:
            ``(Bs, As)`` of shape ``(..., num_bands, 3)``.
        """
        gains = torch.exp(log_gains)
        gains_sq = torch.square(gains)
        neighbor_gains_sq = torch.exp(2.0 * self.c * log_gains)

        beta_mult = torch.sqrt(
            (torch.abs(1.0 - neighbor_gains_sq) + 1e-7)
            / (torch.abs(gains_sq - neighbor_gains_sq) + 1e-7)
        )
        nonzero = torch.abs(log_gains) >= 1e-3
        beta = self.tan_B_half * torch.where(nonzero, beta_mult, 1.0)
        gbeta = gains * beta

        m2_cos_wc = self.m2_cos_wc.expand(log_gains.shape)
        Bs = torch.stack([1.0 + gbeta, m2_cos_wc, 1.0 - gbeta], dim=-1)
        As = torch.stack([1.0 + beta, m2_cos_wc, 1.0 - beta], dim=-1)
        return Bs, As
