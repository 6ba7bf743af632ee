"""Reverbs: STFT-masked noise, filtered-noise shaping and a feedback delay
network (the port of :mod:`grafx_tpu.processors.reverb`; reference:
src/grafx/processors/reverb.py:15-447).

Per-call noise is drawn from a ``noise_key`` (:mod:`grafx_tpu_torch.random`,
bit for bit ``jax.random``'s), which the render executor derives per stage
from its ``rng``; the host-side noise buffers are built at init in numpy,
as ``grafx_tpu`` builds them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch import random
from grafx_tpu_torch.ops.fftconv import FIRConvolution, conv_stream_apply, conv_stream_init
from grafx_tpu_torch.ops.stft import hann_window, istft, stft
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.noise import get_filtered_noise
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


def _stream_conv(processor_channel, ir, num_channels, block_len):
    """The stream contract of a reverb whose IR is ``ir``: a partitioned
    frequency-domain delay line for a long IR, an overlap-add tail for a
    short one (ops/fftconv.py conv_stream_init), in the M/S basis for
    ``"midside"``."""
    state, conv = conv_stream_init(normalize_impulse(ir), num_channels, block_len)
    return state, {"conv": conv, "ms": processor_channel == "midside"}


def _stream_step(x, state, cache):
    if cache["ms"]:
        y, state = conv_stream_apply(lr_to_ms(x), state, cache["conv"])
        return ms_to_lr(y), state
    return conv_stream_apply(x, state, cache["conv"])


def _apply_ir(conv, processor_channel, input_signals, ir):
    """Convolve with the normalized IR, in the M/S basis for ``"midside"``."""
    if processor_channel == "midside":
        return ms_to_lr(conv(lr_to_ms(input_signals), normalize_impulse(ir)))
    return conv(input_signals, normalize_impulse(ir))


class STFTMaskedNoiseReverb(nn.Module):
    """Masked-noise reverb: the STFT of uniform noise x a learnable
    decaying mask -> iSTFT -> causal convolution.

    Args:
        ir_len: impulse-response length.
        processor_channel: ``"mono"``, ``"stereo"``, ``"midside"``, or
            ``"pseudo_midside"`` (mask in M/S, convolve in L/R).
        n_fft / hop_length: STFT parameters.
        fixed_noise: the fixed noise of numpy ``RandomState(0)``, or noise
            drawn on each call from ``noise_key`` (``PRNGKey(0)`` when none
            is given), uniform in [-1, 1) as ``grafx_tpu`` draws it.
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
        **_ignored,
    ):
        super().__init__()
        if processor_channel not in ("mono", "stereo", "midside", "pseudo_midside"):
            raise ValueError(f"Invalid processor_channel: {processor_channel}")
        self.ir_len = ir_len
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_frames = 1 + ir_len // hop_length
        self.num_bins = 1 + n_fft // 2
        self.gain_envelope = gain_envelope
        self.processor_channel = processor_channel
        self.fixed_noise = fixed_noise
        self.conv = FIRConvolution(mode="causal")

        if fixed_noise:
            rng = np.random.RandomState(0)
            noise = 2.0 * rng.uniform(size=(2, ir_len)).astype(np.float32) - 1.0
            noise_stft = _numpy_stft(noise, n_fft, hop_length, hann_window(n_fft))[None]
            self.register_buffer("noise_stft", torch.from_numpy(noise_stft), persistent=False)
        else:
            # the default key on the module's device: a capture copies nothing
            self.register_buffer("default_key", random.PRNGKey(0), persistent=False)
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
        noise_key=None,
    ):
        ir = self.compute_ir(
            init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude, noise_key
        )
        if self.processor_channel == "pseudo_midside":
            return self.conv(input_signals, normalize_impulse(ms_to_lr(ir)))
        return _apply_ir(self.conv, self.processor_channel, input_signals, ir)

    def compute_ir(self, init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude=None,
                   noise_key=None):
        """``(B, 2, ir_len)`` impulse responses (``noise_key`` is read only
        without ``fixed_noise``)."""
        if self.fixed_noise:
            noise_stft = self.noise_stft
        else:
            key = self.default_key if noise_key is None else noise_key
            b = init_log_magnitude.shape[0]
            noise = 2.0 * random.uniform(key, (b, 2, self.ir_len)) - 1.0
            noise_stft = stft(noise, self.n_fft, self.hop_length, self.window)
        mask = self.compute_stft_mask(
            init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude
        )
        return istft(
            noise_stft * mask, self.n_fft, self.hop_length, self.window, length=self.ir_len
        )

    def _lr_ir(self, init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude,
               noise_key):
        """The IR convolved in L/R (``"pseudo_midside"``'s mask is in M/S)."""
        ir = self.compute_ir(
            init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude, noise_key
        )
        return ms_to_lr(ir) if self.processor_channel == "pseudo_midside" else ir

    def fir_kernel(self, init_log_magnitude, delta_log_magnitude,
                   gain_env_log_magnitude=None, noise_key=None):
        """FIR-LTI capability (render/fuse.py): the effective causal IR
        (channel-diagonal modes only)."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside reverb is not channel-diagonal")
        ir = self._lr_ir(init_log_magnitude, delta_log_magnitude, gain_env_log_magnitude,
                         noise_key)
        return normalize_impulse(ir), 0, None

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, noise_key=None, **params):
        """Streaming contract: build the IR once (without ``fixed_noise``,
        from noise drawn once from ``noise_key``) and stream its causal
        convolution."""
        ir = self._lr_ir(params["init_log_magnitude"], params["delta_log_magnitude"],
                         params.get("gain_env_log_magnitude"), noise_key)
        return _stream_conv(self.processor_channel, ir, num_channels, block_len)

    def stream_step(self, x, state, cache):
        return _stream_step(x, state, cache)

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


class FilteredNoiseShapingReverb(nn.Module):
    """K-band filtered noise with per-band exponential decay envelopes
    (reference: reverb.py:231-447).

    ``noise_randomness="pseudo-random"`` reads an ``ir_len`` crop of a
    noise buffer five times as long on each call.  With a ``noise_key``
    the crop starts at ``randint(noise_key, (), 0, limit)``, read by index
    on the key's device (a capture replays it with each new key); without
    one, at the next draw of the instance's own host
    ``np.random.default_rng(0)``, exactly as ``grafx_tpu`` draws it, so
    eager calls without a key match ``grafx_tpu``'s eager calls call for
    call.  A compiled path freezes that host draw: ``make_render_fn``'s
    CUDA graph keeps the crop drawn by its capture, which is the second
    call of a signature (the first warms up), while ``jax.jit`` keeps the
    one drawn by its single trace.  Pass a key (``rng=``) to draw a new
    crop on every replay; use ``"fixed"`` for the whole buffer.
    """

    def __init__(
        self,
        ir_len=60000,
        num_bands=12,
        processor_channel="midside",
        f_min=31.5,
        f_max=15000,
        scale="log",
        sr=30000,
        zerophase=True,
        order=2,
        noise_randomness="pseudo-random",
        use_fade_in=False,
        min_decay_ms=50,
        max_decay_ms=2000,
        **_ignored,
    ):
        super().__init__()
        self.num_bands = num_bands
        self.processor_channel = processor_channel
        if processor_channel in ("midside", "stereo"):
            self.num_channels = 2
        elif processor_channel == "mono":
            self.num_channels = 1
        else:
            raise ValueError(f"Unknown channel type: {processor_channel}")
        if noise_randomness not in ("pseudo-random", "fixed"):
            raise ValueError(f"Invalid noise_randomness: {noise_randomness}")
        self.ir_len = ir_len
        self.noise_randomness = noise_randomness
        noise_len = ir_len if noise_randomness == "fixed" else ir_len * 5
        filtered_noise = get_filtered_noise(
            noise_len,
            num_channels=self.num_channels,
            num_bands=num_bands,
            f_min=f_min,
            f_max=f_max,
            scale=scale,
            sr=sr,
            zerophase=zerophase,
            order=order,
        )
        # (1, C, K, noise_len)
        self.register_buffer(
            "filtered_noise", torch.from_numpy(filtered_noise)[None], persistent=False
        )
        self._crop_rng = np.random.default_rng(0)
        self.conv = FIRConvolution(mode="causal")

        min_decay_db = -60.0 / (min_decay_ms * sr / 1000)
        self.min_decay = min_decay_db / 20 * math.log(10)
        max_decay_db = -60.0 / (max_decay_ms * sr / 1000)
        self.max_decay = max_decay_db / 20 * math.log(10)

        self.use_fade_in = use_fade_in
        self.register_buffer(
            "arange", torch.arange(ir_len, dtype=torch.float32)[None, None, None, :],
            persistent=False,
        )
        self.register_buffer("crop_index", torch.arange(ir_len), persistent=False)

    def forward(self, input_signals, log_decay, log_gain, log_fade_in=None,
                z_fade_in_gain=None, noise_key=None):
        ir = self.compute_ir(log_decay, log_gain, log_fade_in, z_fade_in_gain, noise_key)
        return _apply_ir(self.conv, self.processor_channel, input_signals, ir)

    def compute_ir(self, log_decay, log_gain, log_fade_in=None, z_fade_in_gain=None,
                   noise_key=None):
        """``(B, C, ir_len)`` impulse responses."""
        log_decay = torch.sigmoid(log_decay) * (self.max_decay - self.min_decay) + self.min_decay
        envelope = torch.exp(self.arange * log_decay[..., None])
        if self.use_fade_in:
            log_fade_in = (
                torch.sigmoid(log_fade_in) * (log_decay - self.min_decay) + self.min_decay
            )
            fade_in = torch.exp(self.arange * log_fade_in[..., None])
            fade_in_gain = torch.sigmoid(z_fade_in_gain)[..., None]
            envelope = envelope - fade_in * fade_in_gain
        envelope = envelope * log_gain[..., None]
        return (self.get_noise(noise_key) * envelope).sum(dim=2)

    def get_noise(self, noise_key=None):
        """The ``(1, C, K, ir_len)`` noise of this call (class docstring)."""
        if self.noise_randomness == "fixed":
            return self.filtered_noise
        limit = self.filtered_noise.shape[-1] - self.ir_len
        if noise_key is None:
            start = int(self._crop_rng.integers(0, limit))
            return self.filtered_noise.narrow(-1, start, self.ir_len)
        start = random.randint(noise_key, (), 0, limit)
        return self.filtered_noise.index_select(-1, self.crop_index + start)

    def fir_kernel(self, log_decay, log_gain, log_fade_in=None, z_fade_in_gain=None,
                   noise_key=None):
        """FIR-LTI capability (channel-diagonal modes only)."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside reverb is not channel-diagonal")
        ir = self.compute_ir(log_decay, log_gain, log_fade_in, z_fade_in_gain, noise_key)
        return normalize_impulse(ir), 0, None

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, noise_key=None, **params):
        """Streaming contract: build the IR once from this call's crop and
        stream its causal convolution."""
        ir = self.compute_ir(
            params["log_decay"],
            params["log_gain"],
            params.get("log_fade_in"),
            params.get("z_fade_in_gain"),
            noise_key,
        )
        return _stream_conv(self.processor_channel, ir, num_channels, block_len)

    def stream_step(self, x, state, cache):
        return _stream_step(x, state, cache)

    def parameter_size(self):
        shape = (self.num_channels, self.num_bands)
        size = {"log_decay": shape, "log_gain": shape}
        if self.use_fade_in:
            size["log_fade_in"] = shape
            size["z_fade_in_gain"] = shape
        return size


class FeedbackDelayNetwork(nn.Module):
    """A frequency-sampled feedback delay network (FDN) reverb (the
    reference lists it as a stub, reverb.py:450-460; ``grafx_tpu``
    implements it).

    ``N`` delay lines of static lengths ``m_i``, a Householder feedback
    matrix ``Q = I - (2/N) 1 1^T``, per-line absorption gains ``g_i`` in
    (0, 0.99), input gains ``b`` and per-channel output gains ``C``:

        H(z) = C (I - D(z) G Q)^{-1} D(z) b,    D(z) = diag(z^{-m_i}),

    sampled on the ``ir_len``-point DFT grid, then an irfft to a causal FIR
    and a convolution.

    The solve.  ``I - D G Q = diag(1 - e) + (2/N) e 1^T`` with ``e = D g``
    is a diagonal plus a rank-one term, so Sherman-Morrison solves every
    (batch, frequency) system elementwise:
    ``x = r / (1 - e) - s (1^T r / (1 - e)) / (1 + 1^T s)``, with
    ``s = (2/N) e / (1 - e)``.  That is a handful of elementwise complex
    ops over (B, F, N), which a CUDA graph captures and autograd
    differentiates as it is; ``torch.linalg.solve`` checks its pivots on
    the host, which a capture refuses.  ``grafx_tpu`` calls the batched LU
    solve of ``jnp.linalg.solve``; the two agree to float32 round-off
    (``tests/test_torch_reverb_noise.py``).  ``|e| <= 0.99`` keeps both
    ``1 - e_i`` and the system away from 0 (``D G Q`` has norm below 1).

    Args:
        ir_len: FIR length (and the DFT size of the frequency sampling).
        num_delays: number of delay lines ``N``.
        delay_lengths: explicit lengths (default: the first ``N`` of
            :attr:`PRIMES`).
        processor_channel: ``"mono"``, ``"stereo"``, or ``"midside"``.
    """

    PRIMES = [1031, 1327, 1523, 1871, 2053, 2311, 2617, 2903,
              3167, 3469, 3727, 4001]

    def __init__(self, ir_len=30000, num_delays=6, delay_lengths=None,
                 processor_channel="stereo", **_ignored):
        super().__init__()
        if delay_lengths is None:
            delay_lengths = self.PRIMES[:num_delays]
        if len(delay_lengths) != num_delays:
            raise ValueError(f"{len(delay_lengths)} delay lengths for {num_delays} delay lines")
        if processor_channel == "mono":
            self.num_channels = 1
        elif processor_channel in ("stereo", "midside"):
            self.num_channels = 2
        else:
            raise ValueError(f"Unknown channel type: {processor_channel}")
        self.ir_len = ir_len
        self.num_delays = num_delays
        self.processor_channel = processor_channel
        # delay phasors z^{-m_i} on the rfft grid, (F, N), made in complex128
        # as grafx_tpu makes them
        m = np.asarray(delay_lengths)[None, :]
        k = np.arange(ir_len // 2 + 1)[:, None]
        phasors = np.exp(-2j * np.pi * k * m / ir_len).astype(np.complex64)
        self.register_buffer("delay_phasors", torch.from_numpy(phasors), persistent=False)
        self.conv = FIRConvolution(mode="causal")

    def forward(self, input_signals, z_absorption, input_gains, output_gains):
        """``(B, C, L)`` signals; ``z_absorption`` and ``input_gains``
        ``(B, N)``; ``output_gains`` ``(B, C_rev, N)``."""
        ir = self.compute_ir(z_absorption, input_gains, output_gains)
        return _apply_ir(self.conv, self.processor_channel, input_signals, ir)

    def compute_ir(self, z_absorption, input_gains, output_gains):
        """``(B, C_rev, ir_len)`` impulse responses."""
        g = 0.99 * torch.sigmoid(z_absorption)  # spectral radius < 1
        D = self.delay_phasors[None]  # (1, F, N)
        e = D * g[:, None, :]  # (B, F, N): the diagonal of D G
        rhs = D * input_gains[:, None, :]
        omd = 1.0 - e
        s = e * (2.0 / self.num_delays) / omd
        y = rhs / omd
        x = y - s * (y.sum(-1, keepdim=True) / (1.0 + s.sum(-1, keepdim=True)))
        H = torch.einsum("bcn,bfn->bcf", output_gains.to(x.dtype), x)
        return torch.fft.irfft(H, n=self.ir_len)

    def fir_kernel(self, z_absorption, input_gains, output_gains):
        """FIR-LTI capability (channel-diagonal modes only)."""
        if self.processor_channel == "midside":
            raise NotImplementedError("midside FDN is not channel-diagonal")
        ir = self.compute_ir(z_absorption, input_gains, output_gains)
        return normalize_impulse(ir), 0, None

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, **params):
        ir = self.compute_ir(params["z_absorption"], params["input_gains"],
                             params["output_gains"])
        return _stream_conv(self.processor_channel, ir, num_channels, block_len)

    def stream_step(self, x, state, cache):
        return _stream_step(x, state, cache)

    def parameter_size(self):
        return {
            "z_absorption": self.num_delays,
            "input_gains": self.num_delays,
            "output_gains": (self.num_channels, self.num_delays),
        }
