"""Filtered-noise generation, host-side at processor init (the port of
:mod:`grafx_tpu.processors.core.noise`; reference:
src/grafx/processors/core/noise.py:9-126): Linkwitz-Riley band-splitting
of uniform noise by scipy, in numpy, computed exactly as ``grafx_tpu``
computes it, so both packages hold the same noise bit for bit.
"""

import numpy as np
from scipy import signal
from scipy.signal import butter, sosfilt, sosfiltfilt

from grafx_tpu_torch.processors.core.scale import from_scale, to_scale


def apply_linkwitz_riley(
    input_audio,
    num_bands=2,
    f_min=40,
    f_max=None,
    scale="bark_traunmuller",
    sr=44100,
    zerophase=True,
    order=2,
):
    """Split audio into bands with a Linkwitz-Riley crossover; returns
    ``(num_channels, num_bands, L)``."""
    s_min, s_max = to_scale(f_min, scale), to_scale(f_max, scale)
    num_pts = num_bands * 2 - 1
    s_breaks = np.linspace(s_min, s_max, num_pts)[1::2]
    f_breaks = from_scale(s_breaks, scale)

    filtered_signals = []
    hpfed = input_audio
    for freq in f_breaks:
        lpf_sos = butter(order, freq, "lowpass", fs=sr, output="sos")
        hpf_sos = butter(order, freq, "highpass", fs=sr, output="sos")
        if zerophase:
            lpfed = sosfiltfilt(lpf_sos, input_audio)
            hpfed = sosfiltfilt(hpf_sos, input_audio)
        else:
            lpfed = sosfilt(lpf_sos, sosfilt(lpf_sos, input_audio))
            hpfed = sosfilt(hpf_sos, sosfilt(hpf_sos, input_audio))
        input_audio = hpfed
        filtered_signals.append(lpfed)
    filtered_signals.append(hpfed)
    return np.stack(filtered_signals, 1)


def get_filtered_noise(
    fir_len,
    num_channels=1,
    num_bands=12,
    f_min=31.5,
    f_max=16000,
    scale="log",
    sr=44100,
    zerophase=True,
    order=2,
    rng=None,
):
    """Uniform noise split into Linkwitz-Riley bands; returns a float32
    ``(num_channels, num_bands, fir_len)`` numpy array."""
    rng = np.random.default_rng(0) if rng is None else rng
    noise = 2.0 * rng.random((num_channels, fir_len)) - 1.0
    filtered = apply_linkwitz_riley(
        noise,
        num_bands=num_bands,
        f_min=f_min,
        f_max=f_max,
        scale=scale,
        sr=sr,
        zerophase=zerophase,
        order=order,
    )
    return filtered.astype(np.float32)


def octave_band_filterbank(num_taps, sample_rate):
    """Octave-spaced FIR bandpass bank ``(num_bands, 1, num_taps)``
    (reference: core/noise.py:76-126)."""
    bands = [31.5, 63, 125, 250, 500, 1000, 2000, 4000, 8000, 16000]
    filts = [np.flip(signal.firwin(num_taps, 12, fs=sample_rate))]
    for fc in bands:
        f_min = fc / np.sqrt(2)
        f_max = np.clip(fc * np.sqrt(2), 0, (sample_rate / 2) * 0.999)
        filt = signal.firwin(num_taps, [f_min, f_max], fs=sample_rate, pass_zero=False)
        filts.append(np.flip(filt))
    filts.append(np.flip(signal.firwin(num_taps, 18000, fs=sample_rate, pass_zero=False)))
    return np.stack(filts, 0).astype(np.float32)[:, None, :]
