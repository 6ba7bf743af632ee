"""Low-latency serving on the port: stream a WAV file through a processing
graph block by block and write the processed WAV.

The serving loop a live audio host would run: fixed parameters, a
``StreamRenderer``'s block step exported once with ``torch.export``
(``grafx_tpu_torch.serving``), then one block in -> one block out from
the loaded artifact, with every filter, envelope and reverb state carried
between blocks.  On the card the loaded step replays one CUDA graph.

Usage:
    python examples_torch/serve_stream_wav.py [in.wav] [out.wav] [block] [--device cpu]

Defaults: a synthetic program (a 4 s chirp) when no input is given;
out = outputs/served_torch.wav; block = 4096.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor  # noqa: E402
from grafx_tpu_torch.processors import (  # noqa: E402
    Compressor,
    GraphicEqualizer,
    ParametricEqualizer,
    STFTMaskedNoiseReverb,
    StereoGain,
)
from grafx_tpu_torch.render import StreamRenderer, prepare_render, reorder_for_fast_render  # noqa: E402
from grafx_tpu_torch.serving import export_stream_step, load_stream_step  # noqa: E402
from grafx_tpu_torch.utils import check_device, create_empty_parameters  # noqa: E402

SR = 44100
DEFAULT_OUT = os.path.join("outputs", "served_torch.wav")


def load_input(path):
    """``(sr, (2, T) float32)``: the WAV at ``path``, else the synthetic
    program."""
    from scipy.io import wavfile

    if path and os.path.isfile(path):
        sr, x = wavfile.read(path)
        x = np.asarray(x, np.float32)
        if np.abs(x).max() > 2.0:
            x = x / 32768.0
        if x.ndim == 1:
            x = np.stack([x, x], 1)
        return sr, x.T
    t = np.arange(SR * 4) / SR
    x = 0.4 * np.sin(2 * np.pi * (55 * t + 800 * t**2 / t[-1]))
    return SR, np.stack([x, x]).astype(np.float32)


def build(device):
    """The chain eq -> geq -> comp -> gain -> reverb(30000): ``(processors,
    plan, params)`` on ``device``."""
    procs = {
        "eq": ParametricEqualizer(num_filters=6, backend="exact"),
        "geq": GraphicEqualizer(scale="bark", backend="exact"),
        "comp": Compressor(energy_smoother="ballistics"),
        "gain": StereoGain(),
        "reverb": STFTMaskedNoiseReverb(ir_len=30000),
    }
    for proc in procs.values():
        proc.to(device)
    G = GRAFX(config=NodeConfigs(sorted(procs)))
    G.add_serial_chain(["in", "eq", "geq", "comp", "gain", "reverb", "out"])
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(procs, G, generator=torch.Generator().manual_seed(0),
                                     device=device)
    return procs, plan, params


def to_int16(out):
    """The output as written: peak-normalized 16-bit PCM, ``(T, 2)``."""
    peak = np.abs(out).max() + 1e-9
    return (np.clip(out / peak, -1, 1) * 32767).astype(np.int16).T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("in_path", nargs="?", default=None)
    ap.add_argument("out_path", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("block", type=int, nargs="?", default=4096)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    block = args.block

    sr, audio = load_input(args.in_path)
    procs, plan, params = build(device)
    streamer = StreamRenderer(procs, plan, params, block_len=block)

    # Ship the streaming step as a self-contained artifact (caches and the
    # initial state inside) and serve from the loaded copy: what a separate
    # serving process would do.
    blob = export_stream_step(streamer, torch.zeros(1, 2, block, device=device))
    step, state = load_stream_step(blob)
    print(f"exported streaming step: {len(blob) / 1e6:.1f} MB artifact")

    n_blocks = audio.shape[-1] // block
    x = torch.from_numpy(np.ascontiguousarray(audio[:, : n_blocks * block])).to(device)
    outs, block_ms = [], []
    for xb in x.split(block, dim=-1):  # the first block runs eagerly, the second captures
        ms, (y, state) = timed_ms(lambda: step(xb[None], state), device)
        outs.append(y[0])
        block_ms.append(ms)
    out = torch.cat(outs, dim=-1).cpu().numpy()
    total_ms = sum(block_ms)
    audio_s = n_blocks * block / sr
    steady_ms = float(np.median(block_ms[2:])) if n_blocks > 2 else float("nan")
    print(f"served {audio_s:.1f} s of audio in {total_ms / 1e3:.2f} s"
          f" ({audio_s / (total_ms / 1e3):.1f}x real time incl. capture;"
          f" {steady_ms:.3f} ms/block after it, block {block} = {block / sr * 1000:.0f} ms"
          f" latency, device {device})")

    from scipy.io import wavfile

    os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
    wavfile.write(args.out_path, sr, to_int16(out))
    print(f"wrote {args.out_path}")
    return {"artifact_mb": len(blob) / 1e6, "blocks": n_blocks, "block": block, "sr": sr,
            "audio_s": audio_s, "total_ms": total_ms, "rtf": audio_s / (total_ms / 1e3),
            "block_ms": steady_ms, "out_path": args.out_path, "output": out}


if __name__ == "__main__":
    main()
