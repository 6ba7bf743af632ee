"""Serve the bench.py mixing console once on one NVIDIA GPU through
grafx_tpu_torch, and check every hand-written kernel on the way.

Run from the root of the repository, on a machine with the card:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the
result line):

1. device: the card's name and power limit, TF32 switched off;
2. build: the CUDA kernels compiled from ``grafx_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at small shapes and at the shapes the console gives it, with their
   times;
4. exactness: the exact IIR cascade against scipy float64;
5. serve: three requests of (4, 17, 2, 2^17) through the fused console,
   with every kernel's launch count;
6. card vs CPU: the same console at batch 1, L = 2^14, on the card and
   on the CPU.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

``--profile DIR`` adds, after phase 5, one more warm request under
``torch.profiler``: it prints the request's device ms (CUDA events), host
wall ms, busy device ms and the card's idle share, and writes the
per-op table to ``DIR/profile_request.txt``.
"""

import argparse
import json
import os
import statistics
import time
import subprocess
import sys

import numpy as np
import torch

from grafx_tpu_torch.models import bench_console
from grafx_tpu_torch.ops import _cuda
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.ops.iir import exactness_check_db
from grafx_tpu_torch.render import make_render_fn

SOURCE = "grafx_tpu_torch/csrc/ballistics_gain.cu"
MAX_ABS = 2e-5  # the bound benchmarks/verify_ballistics_tpu.py uses on the TPU
BATCH, CHAINS, AUDIO_LEN = 4, 17, 2**17


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def gain_consts(gen, n, kind, onepole=False, absent=None):
    """(at, rt, th, cf, hk) on the card; ``absent`` rows get cf = 0."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")

    at, rt = u(0.05, 0.9), u(0.01, 0.3)
    if onepole:
        at = rt = u(0.02, 0.5)
    th = u(-3.0, 1.0)
    cf = u(-0.9, -0.2) if kind == "compressor" else u(0.5, 3.0)
    if absent is not None:
        cf = torch.where(absent, 0.0, cf)
    return [at, rt, th, cf, u(0.1, 1.0)]


def energy(gen, n, length):
    x = torch.randn(n, 2, length, generator=gen, device="cuda")
    return torch.mean(torch.square(x), dim=-2)


def device_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernel_cases(gen):
    """(name, kernel call, plain call) at small shapes: both kinds, a
    one-pole member, an absent member and a ragged row count."""
    cases = []
    for n in (68, 8, 37):
        u = energy(gen, n, 2**13)
        for kind in ("compressor", "noisegate"):
            zi = torch.rand(n, generator=gen, device="cuda")
            c = [zi] + gain_consts(gen, n, kind, absent=torch.arange(n, device="cuda") % 5 == 0)
            cases.append(("ballistics_gain_core", n, kind,
                          lambda u=u, c=c, k=kind: bal.ballistics_gain_core(u, *c, kind=k),
                          lambda u=u, c=c, k=kind: bal.ballistics_gain_plain(u, *c, kind=k)))
        for kinds, inits in ((("noisegate", "compressor"), (0.0, 1.0)),
                             (("compressor", "noisegate"), (1.0, 1.0))):
            absent = torch.arange(n, device="cuda") % 3 != 0
            c = gain_consts(gen, n, kinds[0], onepole=inits[0] == 0.0, absent=absent)
            c += gain_consts(gen, n, kinds[1])
            cases.append(("ballistics_gain_pair_core", n, kinds,
                          lambda u=u, c=c, k=kinds, i=inits: bal.ballistics_gain_pair_core(u, *c, kinds=k, inits=i),
                          lambda u=u, c=c, k=kinds, i=inits: bal.ballistics_gain_pair_plain(u, *c, kinds=k, inits=i)))
    return cases


def main_path_cases(gen):
    """The console's two calls: the 17 gate -> compressor composites at
    batch 4 (68 rows; 11 of every 17 gates absent) and the two bus
    compressors at batch 4 (8 rows), over 2^17 samples."""
    n = BATCH * CHAINS
    absent = (torch.arange(n, device="cuda") % CHAINS) % 3 != 0
    u = energy(gen, n, AUDIO_LEN)
    c = gain_consts(gen, n, "noisegate", onepole=True, absent=absent) + gain_consts(gen, n, "compressor")
    kinds, inits = ("noisegate", "compressor"), (0.0, 1.0)
    pair = (lambda: bal.ballistics_gain_pair_core(u, *c, kinds=kinds, inits=inits),
            lambda: bal.ballistics_gain_pair_plain(u, *c, kinds=kinds, inits=inits))
    n = BATCH * 2
    u2 = energy(gen, n, AUDIO_LEN)
    c2 = [torch.ones(n, device="cuda")] + gain_consts(gen, n, "compressor")
    single = (lambda: bal.ballistics_gain_core(u2, *c2, kind="compressor"),
              lambda: bal.ballistics_gain_plain(u2, *c2, kind="compressor"))
    return {"ballistics_gain_pair_core": pair, "ballistics_gain_core": single}


def db(err, ref):
    return 20.0 * torch.log10(torch.linalg.norm(err) / torch.linalg.norm(ref)).item()


def profile_request(render, x, params, out_dir, card):
    """One warm request under torch.profiler.  The busy time is the union
    of the device ops' intervals; the idle share is the rest of the span
    the CUDA events measure."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        ms, _ = device_ms(lambda: render(x, params), reps=1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    check(spans, "the profiler recorded no device op")
    busy_us, (start, end) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us, start, end = busy_us + end - start, s, e
        else:
            end = max(end, e)
    busy_ms = (busy_us + end - start) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, "profile_request.txt")
    with open(table, "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    say("profile", request_ms=f"{ms:.3f}", host_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}", device_ops=len(spans),
        idle_share=f"{max(0.0, 1.0 - busy_ms / ms):.3f}", table=table, card=repr(card))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more warm request and write its table to DIR")
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    say("device", name=repr(kind), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build
    lib = _cuda.library()
    say("build", seconds=f"{lib.build_seconds:.2f}", library=lib.path)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  nvcc:", line.strip(), flush=True)

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0} for name in ("ballistics_gain_pair_core", "ballistics_gain_core")}
    with torch.inference_mode():
        for name, n, kinds, kern, plain in kernel_cases(gen):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            label = kinds if isinstance(kinds, str) else "/".join(kinds)
            say("kernels", case=name, rows=n, kinds=label, max_abs_err=f"{err:.3g}")
            check(err < MAX_ABS, f"{name} N={n} {kinds}: max abs err {err} >= {MAX_ABS}")
        for name, (kern, plain) in main_path_cases(gen).items():
            kern()  # warm-up
            ms, got = device_ms(kern, reps=5)
            plain_ms, ref = device_ms(plain, reps=1)
            err = (got - ref).abs().max().item()
            check(err < MAX_ABS, f"{name} at the console's shape: max abs err {err} >= {MAX_ABS}")
            stats[name].update(ms=ms, plain_ms=plain_ms)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            say("kernels", case=name, shape=tuple(got.shape), max_abs_err=f"{err:.3g}",
                kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.1f}")

    # 4. exactness of the exact IIR cascade on the card
    exact_db = exactness_check_db(device="cuda")
    say("exactness", db=f"{exact_db:.1f}")
    check(exact_db <= -60.0, f"exact IIR cascade at {exact_db:.1f} dB > -60 dB")

    # 5. serve the full-width console
    console = bench_console(CHAINS, seed=0, device="cuda")
    render = make_render_fn(console.fused_processors, console.plan)
    requests = []
    for seed in (1, 2, 3):
        g = torch.Generator(device="cuda").manual_seed(seed)
        requests.append(torch.randn(BATCH, CHAINS, 2, AUDIO_LEN, generator=g, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.ballistics_gain_core.launches = 0
    bal.ballistics_gain_pair_core.launches = 0
    request_ms = []
    with torch.inference_mode():
        for x in requests:
            ms, (y, _, _) = device_ms(lambda x=x: render(x, console.params), reps=1)
            check(y.shape == (BATCH, 1, 2, AUDIO_LEN), f"output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), "non-finite output")
            request_ms.append(ms)
    launches = {
        "ballistics_gain_core": bal.ballistics_gain_core.launches,
        "ballistics_gain_pair_core": bal.ballistics_gain_pair_core.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the serving path")
        stats[name]["launches"] = count
    say("serve", requests=len(request_ms), request_ms=[round(t, 3) for t in request_ms],
        median_ms=f"{statistics.median(request_ms):.3f}", peak_mem_gib=f"{peak_gb:.2f}",
        launches=launches, card=repr(smi))
    if args.profile:
        profile_request(render, requests[-1], console.params, args.profile, smi)

    # 6. the card against the port's CPU path
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, CHAINS, 2, 2**14)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        c = bench_console(CHAINS, seed=5, device=device)
        with torch.inference_mode():
            outs[device] = make_render_fn(c.fused_processors, c.plan)(x.to(device), c.params)[0].cpu()
    card_db = db(outs["cuda"] - outs["cpu"], outs["cpu"])
    say("card_vs_cpu", db=f"{card_db:.1f}")
    check(bool(torch.isfinite(outs["cuda"]).all()), "non-finite card output")
    check(card_db <= -60.0, f"card vs CPU at {card_db:.1f} dB > -60 dB")

    replaces = {
        "ballistics_gain_pair_core": "grafx_tpu/ops/ballistics_tpu.py:826",
        "ballistics_gain_core": "grafx_tpu/ops/ballistics_tpu.py:587",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
         "launches": s["launches"], "max_abs_err": s["max_abs_err"],
         "ms": s["ms"], "plain_ms": s["plain_ms"]}
        for name, s in stats.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
