"""Time the render executor's fan-in of one tree of this repository on
one NVIDIA GPU: the compiled request and the compiled exact step of
bench.py's console at full width (17 chains, batch 4, stereo, 2^17
samples; ``bench_console(17)``, ``bench_trainer(17)``) by CUDA events, the
device ops of one eager and one compiled request and step, and the
console's scatter fan-in (its mix stage, 17 rows into 2) alone: forward,
and forward with backward, by CUDA events, with the device kernels each
runs from ``torch.profiler``.

    python3 scripts/fan_in_ab.py [--tree DIR] [--calls N]

``--tree DIR`` imports ``grafx_tpu_torch`` from DIR, a checkout of
another commit (the parent, unpacked by ``git archive``), in place of
this one's.  Prints the card as ``nvidia-smi`` names it and one JSON
line.  To compare two commits, run it in turns in one call on one card:
parent, change, change, parent.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

BATCH, CHAINS, AUDIO_LEN = 4, 17, 2**17


def device_ms(fn):
    """CUDA-event ms of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, calls):
    return statistics.median(device_ms(fn) for _ in range(calls))


def device_kernels(fn):
    """``{kernel name: [count, device us]}`` of one call of ``fn``, from
    ``torch.profiler``, the call bracketed by two marker kernels and
    profiled again with wider margins where the profiler lost either."""
    from torch.profiler import ProfilerActivity

    from grafx_tpu_torch import profiling

    for margin in profiling._MARGINS_S:
        with profiling._window(margin, [ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda._sleep(1)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(profiling._MARKER in e.name for e in events) == 2:
            break
    else:
        raise RuntimeError("the profiler lost device events of the call")
    kernels = {}
    for e in events:
        if profiling._MARKER not in e.name:
            count, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = [count + 1, us + e.time_range.elapsed_us()]
    return kernels


def ops(kernels):
    return sum(count for count, _ in kernels.values())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the checkout whose grafx_tpu_torch to time")
    parser.add_argument("--calls", type=int, default=20, help="warm calls timed of each path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fan_in_ab: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from grafx_tpu_torch.models import bench_console, bench_trainer
    from grafx_tpu_torch.render import make_render_fn
    from grafx_tpu_torch.render.core import aggregate_tensor

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"tree": tree, "card": card, "calls": args.calls}

    console = bench_console(CHAINS, seed=0, device="cuda")
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    eager = make_render_fn(console.fused_processors, console.plan, jit=False)
    compiled = make_render_fn(console.fused_processors, console.plan)
    with torch.inference_mode():
        for _ in range(2):  # warm-up, capture
            compiled(x, console.params)
        eager(x, console.params)
        result["request_compiled_ms"] = median_ms(lambda: compiled(x, console.params), args.calls)
        result["request_device_ops"] = {
            "eager": ops(device_kernels(lambda: eager(x, console.params))),
            "compiled": ops(device_kernels(lambda: compiled(x, console.params)))}

    # the console's scatter fan-in alone, at the shape the stage gives it
    (stage,) = [s for s in console.plan.iter_list if any(a.method == "scatter" for a in s.aggregations)]
    (agg,) = [a for a in stage.aggregations if a.method == "scatter"]
    rows = torch.randn(BATCH, len(agg.idx), 2, AUDIO_LEN, device="cuda")
    leaf = rows.clone().requires_grad_(True)
    cot = torch.randn(BATCH, agg.num_segments, 2, AUDIO_LEN, device="cuda")

    def forward():
        with torch.no_grad():
            return aggregate_tensor(rows, agg, dim=1)

    def forward_backward():
        return torch.autograd.grad(aggregate_tensor(leaf, agg, dim=1), leaf, cot)

    forward(), forward_backward()
    result["aggregation"] = {
        "idx": list(agg.idx), "rows_shape": list(rows.shape),
        "forward_ms": median_ms(forward, args.calls), "forward_kernels": device_kernels(forward),
        "forward_backward_ms": median_ms(forward_backward, args.calls),
        "forward_backward_kernels": device_kernels(forward_backward)}
    del console, eager, compiled, x, rows, leaf, cot

    trainer = bench_trainer(CHAINS, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=g, device="cuda")
    x = x * torch.where(torch.rand(BATCH, CHAINS, 1, 32, generator=g, device="cuda") < 0.5, 1.0,
                        0.01).repeat_interleave(AUDIO_LEN // 32, dim=-1)  # gates engage (chip_smoke.py)
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    for _ in range(2):  # warm-up, capture
        trainer.step(x, target)
    result["step_compiled_ms"] = median_ms(lambda: trainer.step(x, target), args.calls)
    result["step_device_ops_compiled"] = ops(device_kernels(lambda: trainer.step(x, target)))
    eager_trainer = bench_trainer(CHAINS, seed=0, device="cuda", jit=False)
    eager_trainer.step(x, target)
    result["step_device_ops_eager"] = ops(device_kernels(lambda: eager_trainer.step(x, target)))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
