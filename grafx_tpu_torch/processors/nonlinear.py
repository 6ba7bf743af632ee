"""Tanh distortion (the port of :class:`grafx_tpu.processors.nonlinear.
TanhDistortion`; reference: src/grafx/processors/nonlinear.py:6-112)."""

import torch
from torch import nn


class TanhDistortion(nn.Module):
    """Tanh clipper with optional pre/post gain, bias, and DC removal."""

    def __init__(
        self,
        pre_post_gain=True,
        inverse_post_gain=True,
        remove_dc=False,
        use_bias=False,
    ):
        super().__init__()
        self.pre_post_gain = pre_post_gain
        self.inverse_post_gain = inverse_post_gain
        self.remove_dc = remove_dc
        self.use_bias = use_bias

    def forward(self, input_signals, log_pre_gain=None, log_post_gain=None, bias=None):
        if self.remove_dc:
            input_signals = input_signals - input_signals.mean(-1, keepdim=True)
        if self.pre_post_gain:
            pre_gain = torch.exp(log_pre_gain)[..., None]
            input_signals = input_signals * pre_gain
        if self.use_bias:
            bias = bias[..., None]
            out = torch.tanh(input_signals + bias) - torch.tanh(bias)
        else:
            out = torch.tanh(input_signals)
        if self.pre_post_gain:
            post_gain = (
                1.0 / pre_gain
                if self.inverse_post_gain
                else torch.exp(log_post_gain)[..., None]
            )
            out = out * post_gain
        return out

    def parameter_size(self):
        size = {}
        if self.pre_post_gain:
            size["log_pre_gain"] = 1
            if not self.inverse_post_gain:
                size["log_post_gain"] = 1
        if self.use_bias:
            size["bias"] = 1
        return size
