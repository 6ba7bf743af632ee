"""Neural parameter prediction through the render, on the port.

The amortized workflow behind the GRAFX companion papers (reverse
engineering, automatic mixing): a per-type MLP predicts every node's
processor parameters from audio features of the dry stems, and the whole
stack (prediction, graph render, multi-resolution STFT loss) trains end
to end.  On the card each training step, momentum update included,
replays one captured CUDA graph; the predictor's weights and momenta are
tensors the graph updates in place.

Run:  python examples_torch/neural_mixing.py [--steps 150] [--device cpu]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch.data import convert_to_tensor  # noqa: E402
from grafx_tpu_torch.models import mixing_console  # noqa: E402
from grafx_tpu_torch.models.predictor import ParameterPredictor, audio_features  # noqa: E402
from grafx_tpu_torch.ops.losses import (  # noqa: E402
    multi_resolution_stft_loss_precomputed,
    precompute_stft_targets,
)
from grafx_tpu_torch.render import (  # noqa: E402
    CapturedFunction,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import check_device, count_nodes_per_type, create_empty_parameters  # noqa: E402

SR = 44100
LR, MOMENTUM = 3e-3, 0.9


def synthetic_stems(num_tracks, length, generator):
    t = torch.arange(length) / SR
    stems = []
    for i in range(num_tracks):
        f0 = 110.0 * (2.0 ** (i / 3.0))
        tone = 0.3 * torch.sin(2 * math.pi * f0 * t)
        noise = 0.05 * torch.randn(length, generator=generator)
        mono = tone + noise
        stems.append(torch.stack([mono, torch.roll(mono, 64)]))
    return torch.stack(stems)


def console(num_tracks, device):
    """The default ``mixing_console`` on ``device`` and its beam plan:
    ``(G, processors, plan)``."""
    G, processors = mixing_console(num_tracks=num_tracks)
    for proc in processors.values():
        proc.to(device)
    return G, processors, prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))


def problem(num_tracks, length, device):
    """The console, its stems and the ground-truth mix of a random
    parameter set (seed 7, std 0.5), on ``device``: ``(G, processors,
    plan, stems, target)``."""
    G, processors, plan = console(num_tracks, device)
    stems = synthetic_stems(num_tracks, length, torch.Generator().manual_seed(0)).to(device)
    gt_params = create_empty_parameters(processors, G, generator=torch.Generator().manual_seed(7),
                                        std=0.5, device=device)
    with torch.no_grad():
        target = make_render_fn(processors, plan)(stems, gt_params)[0]
    return G, processors, plan, stems, target


def conditioning(G, processors, stems, generator):
    """The predictor (drawn from ``generator``) and its input: every node
    of a type sees the mean features of the stems (one shared feature
    vector per node).  Returns ``(predictor, features_per_type)``."""
    with torch.no_grad():
        mean_feat = audio_features(stems, num_bands=32).mean(dim=0)  # (2 * bands,)
    predictor = ParameterPredictor(processors, feature_dim=mean_feat.shape[0],
                                   generator=generator).to(stems.device)
    features_per_type = {
        t: mean_feat[None].expand(n, mean_feat.shape[0])
        for t, n in count_nodes_per_type(G).items()
        if t in processors and n > 0
    }
    return predictor, features_per_type


def loss_of(predictor, features_per_type, render, stems, target_specs):
    """The MR-STFT loss of the predicted parameters' render."""
    out = render(stems, predictor(features_per_type))[0]
    return multi_resolution_stft_loss_precomputed(out, target_specs)


def make_step(predictor, features_per_type, render):
    """``step(stems, target_specs) -> loss``: :func:`loss_of`, its
    gradient in the predictor's weights, and SGD with momentum (``m =
    0.9 m + g; w -= 3e-3 m``) in place; on the card one CUDA graph (the
    first call runs eagerly, the second captures)."""
    weights = list(predictor.parameters())
    momenta = [torch.zeros_like(w) for w in weights]

    def update(stems, target_specs):
        for w in weights:
            w.grad = None
        loss = loss_of(predictor, features_per_type, render, stems, target_specs)
        loss.backward()
        with torch.no_grad():
            for w, m in zip(weights, momenta):
                m.mul_(MOMENTUM).add_(w.grad)
                w.sub_(LR * m)
        return loss.detach()

    return CapturedFunction(update, name="neural_mixing step")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--tracks", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=0.8)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    length = int(args.seconds * SR)

    G, processors, plan, stems, target = problem(args.tracks, length, device)
    with torch.no_grad():
        target_specs = precompute_stft_targets(target)
    predictor, features_per_type = conditioning(G, processors, stems,
                                                torch.Generator().manual_seed(1))
    step = make_step(predictor, features_per_type, make_render_fn(processors, plan, jit=False))

    losses = []

    def train():
        for i in range(args.steps):
            losses.append(step(stems, target_specs))
            if i % 25 == 0:
                print(f"step {i:4d}  loss {losses[-1].item():.4f}")

    ms, _ = timed_ms(train, device)
    loss0, final = losses[0].item(), losses[-1].item()
    print(f"done: loss {loss0:.4f} -> {final:.4f} ({args.steps} steps, {ms / 1e3:.1f}s,"
          f" {ms / args.steps:.1f} ms/step, device={device})")
    assert final < loss0, "training did not reduce the loss"
    return {"nodes": G.number_of_nodes(), "tracks": args.tracks, "length": length, "steps": args.steps,
            "train_ms": ms, "step_ms": ms / args.steps, "loss_first": loss0, "loss_last": final,
            "weights": sum(w.numel() for w in predictor.parameters()),
            "compressor_stages": sum(s.node_type == "compressor" for s in plan.iter_list)}


if __name__ == "__main__":
    main()
