"""Stereo gain (the port of :class:`grafx_tpu.processors.stereo.
StereoGain`; reference: src/grafx/processors/stereo.py:9-48)."""

import torch
from torch import nn


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
