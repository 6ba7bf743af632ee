"""STFTMaskedNoiseReverb, pseudo mid/side: a fixed stereo noise (numpy
``RandomState(0)``, uniform in [-1, 1), drawn in float32), its STFT
(Hann window, reflect-padded frames) times a mask decaying per frame in
mid/side, the inverse STFT (windowed overlap-add over the window's
squared sum), mid/side to left/right, scaled to unit mean channel energy,
and convolved causally with the signal."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import lti


def _settings(args):
    if (args.get("processor_channel", "pseudo_midside") != "pseudo_midside"
            or not args.get("fixed_noise", True) or args.get("gain_envelope")):
        raise NotImplementedError("the reference has the pseudo mid/side, fixed-noise reverb only")
    return args.get("ir_len", 60000), args.get("n_fft", 384), args.get("hop_length", 192)


def parameter_size(args):
    _, n_fft, _ = _settings(args)
    bins = n_fft // 2 + 1
    return {"init_log_magnitude": (2, bins), "delta_log_magnitude": (2, bins)}


def _window(n_fft, dtype, device):
    t = torch.arange(n_fft, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * t / n_fft))


def noise_stft(ir_len, n_fft, hop, dtype, device):
    """``(2, n_fft // 2 + 1, 1 + ir_len // hop)`` spectrogram of the noise."""
    u = np.random.RandomState(0).uniform(size=(2, ir_len)).astype(np.float32)
    noise = 2.0 * torch.as_tensor(u, dtype=dtype, device=device) - 1.0
    pad = n_fft // 2
    padded = torch.cat([noise[:, 1:pad + 1].flip(-1), noise,
                        noise[:, ir_len - 1 - pad:ir_len - 1].flip(-1)], -1)
    frames = padded.unfold(-1, n_fft, hop)[:, : 1 + ir_len // hop]
    return torch.fft.rfft(frames * _window(n_fft, dtype, device), n=n_fft).transpose(-1, -2)


def impulse_response(p, args):
    ir_len, n_fft, hop = _settings(args)
    init = p["init_log_magnitude"]
    dtype, device = init.dtype, init.device
    spec = noise_stft(ir_len, n_fft, hop, dtype, device)
    frames = spec.shape[-1]
    k = torch.arange(frames, dtype=dtype, device=device)
    mask = torch.exp((init[..., None] - F.softplus(p["delta_log_magnitude"])[..., None] * k) / 8.0)
    window = _window(n_fft, dtype, device)
    seg = torch.fft.irfft((spec * mask).transpose(-1, -2), n=n_fft) * window
    total = n_fft + hop * (frames - 1)
    out = torch.zeros(seg.shape[:-2] + (total,), dtype=dtype, device=device)
    norm = torch.zeros(total, dtype=dtype, device=device)
    for f in range(frames):
        out[..., f * hop: f * hop + n_fft] += seg[..., f, :]
        norm[f * hop: f * hop + n_fft] += window * window
    ir = (out / torch.clamp(norm, min=1e-11))[..., n_fft // 2: n_fft // 2 + ir_len]
    mid, side = ir[:, :1], ir[:, 1:]
    lr = torch.cat([mid + side, mid - side], 1)
    energy = (lr * lr).sum(-1, keepdim=True).mean(1, keepdim=True)
    return lr / torch.sqrt(energy + 1e-12)


def render(x, p, args, ctx):
    return lti.causal_conv(x, impulse_response(p, args), ctx)


def flops(rows, channels, length, args):
    ir_len, n_fft, hop = _settings(args)
    frames = 1 + ir_len // hop
    design = rows * 2 * frames * (lti.fft_flops(n_fft) + 4 * n_fft)
    return design + lti.fft_conv_flops(rows * channels, length, ir_len)
