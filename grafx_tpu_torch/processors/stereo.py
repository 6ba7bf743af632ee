"""Stereo utility processors (the port of :mod:`grafx_tpu.processors.
stereo`; reference: src/grafx/processors/stereo.py:9-205).

``StereoToMidSide`` returns a list of two signals, one per outlet (the
render executor's multi-outlet contract), and ``MidSideToStereo`` takes
one signal per inlet, as in ``grafx_tpu``.
"""

import math

import torch
from torch import nn

INV_SQRT_2 = 1.0 / math.sqrt(2.0)


def _check_channels(x, channels, name):
    if x.shape[-2] != channels:
        raise ValueError(f"{name} takes {channels}-channel signals, got {tuple(x.shape)}")


class StereoGain(nn.Module):
    """Channel-wise log-gain."""

    def forward(self, input_signals, log_gain):
        """``(B, C, L)`` signals x ``(B, 2)`` log-gains -> ``(B, 2, L)``."""
        return input_signals * torch.exp(log_gain)[..., None]

    def fir_kernel(self, log_gain):
        """FIR-LTI capability: a gain is a 1-tap causal FIR."""
        return torch.exp(log_gain)[..., None], 0, None

    def parameter_size(self):
        return {"log_gain": 2}


class SideGainImager(nn.Module):
    """Side-channel loudness control (reference: stereo.py:51-99)."""

    def forward(self, input_signals, log_gain):
        """``(B, 2, L)`` signals x ``(B, 1)`` side log-gain."""
        _check_channels(input_signals, 2, type(self).__name__)
        left, right = input_signals[:, 0, :], input_signals[:, 1, :]
        mid, side = left + right, left - right
        side = torch.exp(log_gain) * side
        return torch.stack([(mid + side) / 2, (mid - side) / 2], dim=1)

    def parameter_size(self):
        return {"log_gain": 1}


class MonoToStereo(nn.Module):
    """Duplicate a mono signal to stereo (reference: stereo.py:102-131)."""

    def forward(self, input_signals):
        _check_channels(input_signals, 1, type(self).__name__)
        return input_signals.repeat(1, 2, 1)

    def parameter_size(self):
        return {}


class StereoToMidSide(nn.Module):
    """Stereo -> (mid, side), a two-outlet processor (reference:
    stereo.py:134-168)."""

    def __init__(self, normalize=True):
        super().__init__()
        self.normalize = normalize

    def forward(self, input_signals):
        _check_channels(input_signals, 2, type(self).__name__)
        if self.normalize:
            input_signals = input_signals * INV_SQRT_2
        left, right = input_signals[:, :1, :], input_signals[:, 1:, :]
        return [left + right, left - right]

    def parameter_size(self):
        return {}


class MidSideToStereo(nn.Module):
    """(mid, side) -> stereo, a two-inlet processor (reference:
    stereo.py:171-205)."""

    def __init__(self, normalize=True):
        super().__init__()
        self.normalization_const = INV_SQRT_2 if normalize else 0.5

    def forward(self, mid, side):
        _check_channels(mid, 1, type(self).__name__)
        return torch.cat([mid + side, mid - side], dim=1) * self.normalization_const

    def parameter_size(self):
        return {}
