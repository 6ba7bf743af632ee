"""STFT-masked noise reverb with fixed noise (the port of
:class:`grafx_tpu.processors.reverb.STFTMaskedNoiseReverb`; reference:
src/grafx/processors/reverb.py:15-228)."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch.ops.fftconv import FIRConvolution, conv_stream_apply, conv_stream_init
from grafx_tpu_torch.ops.stft import hann_window, istft
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.utils import normalize_impulse


def _numpy_stft(x, n_fft, hop_length, window):
    """Host-side STFT (center=True, reflect pad), computed exactly as
    ``grafx_tpu.processors.reverb._numpy_stft`` does, so both packages
    hold the same fixed noise spectrogram bit for bit."""
    L = x.shape[-1]
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)], "reflect")
    num_frames = 1 + L // hop_length
    starts = np.arange(num_frames) * hop_length
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    frames = xp[..., idx] * window
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return np.swapaxes(spec, -1, -2).astype(np.complex64)


class STFTMaskedNoiseReverb(nn.Module):
    """Masked-noise reverb: the STFT of fixed uniform noise (numpy
    ``RandomState(0)``) x a learnable decaying mask -> iSTFT -> causal
    convolution.

    Args:
        ir_len: impulse-response length.
        processor_channel: ``"mono"``, ``"stereo"``, ``"midside"``, or
            ``"pseudo_midside"`` (mask in M/S, convolve in L/R).
        n_fft / hop_length: STFT parameters.
        fixed_noise: only ``True`` (per-call noise is not ported yet).
        gain_envelope: add a frequency-independent per-frame gain.
    """

    def __init__(
        self,
        ir_len=60000,
        processor_channel="pseudo_midside",
        n_fft=384,
        hop_length=192,
        fixed_noise=True,
        gain_envelope=False,
    ):
        super().__init__()
        if not fixed_noise:
            raise NotImplementedError("per-call reverb noise is not ported yet.")
        if processor_channel not in ("mono", "stereo", "midside", "pseudo_midside"):
            raise ValueError(f"Invalid processor_channel: {processor_channel}")
        self.ir_len = ir_len
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_frames = 1 + ir_len // hop_length
        self.num_bins = 1 + n_fft // 2
        self.gain_envelope = gain_envelope
        self.processor_channel = processor_channel
        self.conv = FIRConvolution(mode="causal")

        rng = np.random.RandomState(0)
        noise = 2.0 * rng.uniform(size=(2, ir_len)).astype(np.float32) - 1.0
        noise_stft = _numpy_stft(noise, n_fft, hop_length, hann_window(n_fft))[None]
        self.register_buffer("noise_stft", torch.from_numpy(noise_stft), persistent=False)
        self.register_buffer(
            "window",
            torch.as_tensor(hann_window(n_fft), dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "arange",
            torch.arange(self.num_frames, dtype=torch.float32)[None, None, None, :],
            persistent=False,
        )

    def forward(
        self,
        input_signals,
        init_log_magnitude,
        delta_log_magnitude,
        gain_env_log_magnitude=None,
    ):
        ir = self.compute_ir(init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude)
        match self.processor_channel:
            case "mono" | "stereo":
                return self.conv(input_signals, normalize_impulse(ir))
            case "midside":
                x = lr_to_ms(input_signals)
                return ms_to_lr(self.conv(x, normalize_impulse(ir)))
            case "pseudo_midside":
                return self.conv(input_signals, normalize_impulse(ms_to_lr(ir)))

    def compute_ir(self, init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude=None):
        """``(B, 2, ir_len)`` impulse responses."""
        mask = self.compute_stft_mask(
            init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude
        )
        return istft(
            self.noise_stft * mask, self.n_fft, self.hop_length, self.window,
            length=self.ir_len,
        )

    def fir_kernel(self, init_log_magnitude, delta_log_magnitude,
                   gain_env_log_magnitude=None):
        """FIR-LTI capability (render/fuse.py): the effective causal IR
        (channel-diagonal modes only)."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside reverb is not channel-diagonal")
        ir = self.compute_ir(init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude)
        if self.processor_channel == "pseudo_midside":
            ir = ms_to_lr(ir)
        return normalize_impulse(ir), 0, None

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, noise_key=None, **params):
        """Streaming contract: build the IR once and stream its causal
        convolution (a partitioned frequency-domain delay line for long
        IRs, an overlap-add tail for short ones; ops/fftconv.py
        conv_stream_init).  The noise is the fixed one: a per-stream
        ``noise_key`` raises until rng threading is ported."""
        if noise_key is not None:
            raise NotImplementedError(
                "a per-stream reverb noise_key needs rng threading, which is"
                " not ported yet (ROADMAP.md, queue 1)."
            )
        ir = self.compute_ir(
            params["init_log_magnitude"],
            params["delta_log_magnitude"],
            params.get("gain_env_log_magnitude"),
        )
        if self.processor_channel == "pseudo_midside":
            ir = ms_to_lr(ir)
        state, conv = conv_stream_init(normalize_impulse(ir), num_channels, block_len)
        return state, {"conv": conv, "ms": self.processor_channel == "midside"}

    def stream_step(self, x, state, cache):
        if cache["ms"]:
            y, state = conv_stream_apply(lr_to_ms(x), state, cache["conv"])
            return ms_to_lr(y), state
        return conv_stream_apply(x, state, cache["conv"])

    def compute_stft_mask(
        self, init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude=None
    ):
        init = init_log_magnitude[:, :, :, None]
        delta = -F.softplus(delta_log_magnitude)[:, :, :, None]
        mask_log = init + delta * self.arange
        if self.gain_envelope:
            mask_log = mask_log + gain_env_log_magnitude[:, :, None, :]
        return torch.exp(mask_log / 8.0)

    def parameter_size(self):
        size = {
            "init_log_magnitude": (2, self.num_bins),
            "delta_log_magnitude": (2, self.num_bins),
        }
        if self.gain_envelope:
            size["gain_env_log_magnitude"] = (2, self.num_frames)
        return size
