"""Frequency-scale conversions: Hz <-> bark / mel / linear / log.

Behavioral parity with the reference scales
(reference: src/grafx/processors/core/scale.py:7-182).  These run at
processor-init time on host, so they are plain numpy (elementwise-correct,
unlike the reference's scalar-only bark correction branches).
"""

import numpy as np


def hz_to_bark(freqs, bark_scale="traunmuller"):
    if bark_scale not in ("schroeder", "traunmuller", "wang"):
        raise ValueError(
            'bark_scale should be one of "schroeder", "traunmuller" or "wang".'
        )
    freqs = np.asarray(freqs, dtype=np.float64)
    if bark_scale == "wang":
        return 6.0 * np.arcsinh(freqs / 600.0)
    if bark_scale == "schroeder":
        return 7.0 * np.arcsinh(freqs / 650.0)
    barks = ((26.81 * freqs) / (1960.0 + freqs)) - 0.53
    barks = np.where(barks < 2, barks + 0.15 * (2 - barks), barks)
    barks = np.where(barks > 20.1, barks + 0.22 * (barks - 20.1), barks)
    return barks


def bark_to_hz(barks, bark_scale="traunmuller"):
    if bark_scale not in ("schroeder", "traunmuller", "wang"):
        raise ValueError(
            'bark_scale should be one of "traunmuller", "schroeder" or "wang".'
        )
    barks = np.asarray(barks, dtype=np.float64)
    if bark_scale == "wang":
        return 600.0 * np.sinh(barks / 6.0)
    if bark_scale == "schroeder":
        return 650.0 * np.sinh(barks / 7.0)
    barks = np.where(barks < 2, (barks - 0.3) / 0.85, barks)
    barks = np.where(barks > 20.1, (barks + 4.422) / 1.22, barks)
    return 1960.0 * ((barks + 0.53) / (26.28 - barks))


def hz_to_mel(freqs, mel_scale="htk"):
    if mel_scale not in ("slaney", "htk"):
        raise ValueError('mel_scale should be one of "htk" or "slaney".')
    freqs = np.asarray(freqs, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freqs / 700.0)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freqs >= min_log_hz,
        min_log_mel + np.log(np.maximum(freqs, 1e-12) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels, mel_scale="htk"):
    if mel_scale not in ("slaney", "htk"):
        raise ValueError('mel_scale should be one of "htk" or "slaney".')
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


def hz_to_log(freqs):
    return np.log(np.asarray(freqs, dtype=np.float64))


def log_to_hz(logs):
    return np.exp(np.asarray(logs, dtype=np.float64))


def to_scale(freqs, scale):
    match scale:
        case "bark_traunmuller" | "bark_schroeder" | "bark_wang":
            return hz_to_bark(freqs, bark_scale=scale.split("_")[1])
        case "mel_htk" | "mel_slaney":
            return hz_to_mel(freqs, mel_scale=scale.split("_")[1])
        case "linear":
            return np.asarray(freqs, dtype=np.float64)
        case "log":
            return hz_to_log(freqs)
        case _:
            raise ValueError(f"Unsupported scale: {scale}")


def from_scale(freqs, scale):
    match scale:
        case "bark_traunmuller" | "bark_schroeder" | "bark_wang":
            return bark_to_hz(freqs, bark_scale=scale.split("_")[1])
        case "mel_htk" | "mel_slaney":
            return mel_to_hz(freqs, mel_scale=scale.split("_")[1])
        case "linear":
            return np.asarray(freqs, dtype=np.float64)
        case "log":
            return log_to_hz(freqs)
        case _:
            raise ValueError(f"Unsupported scale: {scale}")
