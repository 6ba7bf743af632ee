"""Gradient-match a target mix with a console graph, on the port.

Builds a mixing console, renders synthetic stems through a "ground
truth" parameter set to make a target mix, then recovers matching
parameters from scratch by gradient descent on a multi-resolution STFT
loss: the canonical GRAFX workflow, end to end.  On the card each
optimizer step replays one captured CUDA graph of the whole update.

Run:  python examples_torch/match_mix.py [--steps 200] [--device cpu]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch.checkpoint import save_session  # noqa: E402
from grafx_tpu_torch.models import GraphParameterOptimizer, mixing_console  # noqa: E402
from grafx_tpu_torch.utils import check_device, tree_leaves  # noqa: E402

SR = 44100


def synthetic_stems(num_tracks, length, generator):
    """Tonal + noisy synthetic stems with distinct spectra per track,
    ``(num_tracks, 2, length)``."""
    t = torch.arange(length) / SR
    stems = []
    for i in range(num_tracks):
        f0 = 80.0 * (2.0 ** (i / 2.0))
        tone = 0.3 * torch.sin(2 * math.pi * f0 * t) * torch.exp(-((t % 0.5) * 4))
        noise = 0.05 * torch.randn(length, generator=generator)
        mono = tone + noise
        pan = i / max(num_tracks - 1, 1)
        stems.append(torch.stack([mono * (1 - 0.5 * pan), mono * (0.5 + 0.5 * pan)]))
    return torch.stack(stems)


def signal_length(seconds):
    """The stems' length: ``seconds`` of audio rounded up to a power of 2."""
    return 1 << int(seconds * SR).bit_length()


def console(num_tracks):
    """eq -> compressor -> gain a track, a geq bus and an 8000-tap reverb
    send: ``(G, processors)``."""
    return mixing_console(
        num_tracks=num_tracks,
        track_chain=("eq", "compressor", "gain"),
        bus_chain=("geq",),
        reverb_send=True,
        ir_len=8000,
    )


def perturb(params):
    """The ground truth: every leaf plus 0.3 N(0, 1), one draw of seed 8
    a leaf, in place."""
    with torch.no_grad():
        for p in tree_leaves(params):
            p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(8)).to(p.device))


def problem(num_tracks, length, device):
    """The console, its stems and the target mix that the ground truth
    renders, on ``device``: ``(G, processors, stems, target)``."""
    G, processors = console(num_tracks)
    stems = synthetic_stems(num_tracks, length, torch.Generator().manual_seed(0)).to(device)
    opt_gt = GraphParameterOptimizer(G, processors, generator=torch.Generator().manual_seed(7),
                                     device=device)
    perturb(opt_gt.params)
    return G, processors, stems, opt_gt.render_current(stems)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tracks", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--save", type=str, default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    length = signal_length(args.seconds)

    # ground-truth parameters -> target mix
    G, processors, stems, target = problem(args.tracks, length, device)
    print(f"console: {G.number_of_nodes()} nodes, device={device}")
    print("target rendered:", tuple(target.shape))

    # recover parameters from scratch
    opt = GraphParameterOptimizer(G, processors, generator=torch.Generator().manual_seed(1),
                                  device=device)
    ms, history = timed_ms(lambda: opt.fit(stems, target, num_steps=args.steps, log_every=50),
                           device)
    print(f"fit {args.steps} steps in {ms / 1e3:.1f}s ({ms / args.steps:.1f} ms/step);"
          f" loss {history[0]:.4f} -> {history[-1]:.4f}")
    assert history[-1] < history[0], "optimization did not reduce the loss"

    if args.save:
        save_session(args.save, G, opt.params, metadata={"steps": args.steps})
        print(f"session saved to {args.save}")
    compressor_stages = sum(s.node_type == "compressor" for s in opt.render_data.iter_list)
    return {"nodes": G.number_of_nodes(), "tracks": args.tracks, "length": length, "steps": args.steps,
            "fit_ms": ms, "step_ms": ms / args.steps, "loss_first": history[0],
            "loss_last": history[-1], "compressor_stages": compressor_stages}


if __name__ == "__main__":
    main()
