"""Multitap delay with learnable (surrogate) delay lengths (the port of
:class:`grafx_tpu.processors.delay.MultitapDelay`; reference:
src/grafx/processors/delay.py:12-177)."""

import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch.ops.fftconv import conv_stream_apply, conv_stream_init
from grafx_tpu_torch.processors.core.convolution import FIRConvolution, convolve
from grafx_tpu_torch.processors.core.delay import SurrogateDelay
from grafx_tpu_torch.processors.core.fir import ZeroPhaseFIR
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.utils import normalize_impulse


class MultitapDelay(nn.Module):
    """M = segments x taps surrogate delays, each optionally coloured by a
    small zero-phase FIR; the taps are concatenated along time to span
    ``segment_len * num_segments``.

    Returns ``(signals, {"radii_reg": loss})``: the aux loss pushes the
    delays sharp (near the unit circle).
    """

    def __init__(
        self,
        segment_len=3000,
        num_segments=20,
        num_delay_per_segment=1,
        processor_channel="stereo",
        zp_filter_per_tap=True,
        zp_filter_bins=20,
        pre_delay=0,
        **surrogate_delay_kwargs,
    ):
        super().__init__()
        self.segment_len = segment_len
        self.num_segments = num_segments
        self.num_delay_per_segment = num_delay_per_segment
        self.zp_filter_per_tap = zp_filter_per_tap
        self.zp_filter_bins = zp_filter_bins
        if zp_filter_per_tap:
            self.zp_filter = ZeroPhaseFIR(zp_filter_bins)
        self.delay = SurrogateDelay(N=segment_len, **surrogate_delay_kwargs)
        self.conv = FIRConvolution(mode="causal")
        self.pre_delay = pre_delay
        self.processor_channel = processor_channel
        match processor_channel:
            case "mono":
                self.num_channels = 1
            case "stereo" | "midside":
                self.num_channels = 2
            case _:
                raise ValueError(f"Unknown channel type: {processor_channel}")

    def forward(self, input_signals, delay_z, log_fir_magnitude=None):
        ir, intermediates = self.get_ir(delay_z, log_fir_magnitude)
        if self.processor_channel == "midside":
            output_signals = ms_to_lr(self.conv(lr_to_ms(input_signals), ir))
        else:
            output_signals = self.conv(input_signals, ir)
        if self.pre_delay != 0:
            output_signals = F.pad(output_signals, (self.pre_delay, 0))[..., : -self.pre_delay]
        return output_signals, intermediates

    def get_ir(self, delay_z, log_fir_magnitude):
        """``(B, num_channels, num_segments * segment_len)`` unit-energy tap
        IRs and ``{"radii_reg": loss}``."""
        z_c = delay_z[..., 0] + 1j * delay_z[..., 1]
        irs, radii_loss = self.delay(z_c)  # (B, M, T)
        if self.zp_filter_per_tap:
            irs = convolve(irs, self.zp_filter(log_fir_magnitude), mode="zerophase")
        B, T = irs.shape[0], irs.shape[-1]
        irs = irs.reshape(B, self.num_channels, self.num_segments, self.num_delay_per_segment, T)
        irs = irs.sum(dim=-2)  # the taps within a segment
        irs = irs.reshape(B, self.num_channels, self.num_segments * T)
        return normalize_impulse(irs), {"radii_reg": radii_loss}

    def _causal_ir(self, delay_z, log_fir_magnitude):
        """The tap IR with ``pre_delay`` folded in as a leading zero pad."""
        ir, intermediates = self.get_ir(delay_z, log_fir_magnitude)
        if self.pre_delay:
            ir = F.pad(ir, (self.pre_delay, 0))
        return ir, intermediates

    def fir_kernel(self, delay_z, log_fir_magnitude=None):
        """FIR-LTI capability: the tap IR with ``pre_delay`` folded in; the
        aux ``radii_reg`` flows through fusion."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside delay is not channel-diagonal")
        ir, intermediates = self._causal_ir(delay_z, log_fir_magnitude)
        return ir, 0, intermediates

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, **params):
        """Streaming contract: the tap IR is fixed per stream, with
        ``pre_delay`` folded in (the one-shot output shift); the aux
        ``radii_reg`` loss is a training quantity and is not emitted."""
        ir, _ = self._causal_ir(params["delay_z"], params.get("log_fir_magnitude"))
        state, conv = conv_stream_init(ir, num_channels, block_len)
        return state, {"conv": conv, "ms": self.processor_channel == "midside"}

    def stream_step(self, x, state, cache):
        if cache["ms"]:
            y, state = conv_stream_apply(lr_to_ms(x), state, cache["conv"])
            return ms_to_lr(y), state
        return conv_stream_apply(x, state, cache["conv"])

    def parameter_size(self):
        num_delay = self.num_segments * self.num_delay_per_segment * self.num_channels
        size = {"delay_z": (num_delay, 2)}
        if self.zp_filter_per_tap:
            size["log_fir_magnitude"] = (num_delay, self.zp_filter_bins)
        return size
