"""Serve, train and stream the bench.py mixing console on one NVIDIA GPU
through grafx_tpu_torch, and check every hand-written kernel on the way.

Run from the root of the repository, on a machine with the card:

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero
before the result line):

1. device: the card's name and power limit, TF32 switched off;
2. build: the CUDA kernels compiled from ``grafx_tpu_torch/csrc``;
3. kernels: each of the seven kernels against its plain PyTorch version
   on the card, at small shapes and at the shapes the console gives it,
   with their times (the plain ballistics walk #7 also split in two,
   carrying its state, against one walk);
4. exactness: the exact IIR cascade against scipy float64;
5. serve: three requests of (4, 17, 2, 2^17) through the fused console,
   with every kernel's launch count (the primal kernels #1/#2 only);
6. train: three gradient steps of ``bench_trainer(17)`` at (4, 17, 2,
   2^17), with device ms per step, peak memory, the losses, which leaves
   moved, and every kernel's launch count (the training kernels #3-#6
   only);
7. grad card vs CPU: the trainer's loss and every parameter gradient at
   batch 1, L = 2^14, on the card and on the CPU;
8. card vs CPU: the served console at batch 1, L = 2^14, on the card and
   on the CPU;
9. stream: (17, 2, 2^17) through ``StreamRenderer`` in 32 blocks of
   4096, with device and host ms per block, the real-time factor, peak
   memory and every kernel's launch count (#7 only), the streamed output
   against the one-shot render on the card, and ``step_many`` (4 blocks)
   against single steps.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

``--profile DIR`` adds, after phase 5, one more warm request, after phase
6, one more warm step and, after phase 9, one more warm block under
``torch.profiler``: each prints its device ms (CUDA events), host wall
ms, busy device ms and the card's idle share, and writes its per-op
table to ``DIR/profile_request.txt``, ``DIR/profile_step.txt`` and
``DIR/profile_stream_block.txt``.
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

from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.ops import _cuda
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.ops.iir import exactness_check_db
from grafx_tpu_torch.render import StreamRenderer, make_render_fn
from grafx_tpu_torch.utils import tree_items

GAIN_SRC = "grafx_tpu_torch/csrc/ballistics_gain.cu"
GRAD_SRC = "grafx_tpu_torch/csrc/ballistics_grad.cu"
# name -> (source, the TPU kernel it replaces), in the order of PERF.md's table
KERNELS = {
    "ballistics_gain_pair_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:826"),
    "ballistics_gain_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:587"),
    "ballistics_gain_pair_fwd": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:747"),
    "ballistics_gain_pair_bwd": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:892"),
    "ballistics_gain_fwd": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:449"),
    "ballistics_gain_bwd": (GRAD_SRC, "grafx_tpu/ops/ballistics_tpu.py:496"),
    "ballistics_core": (GAIN_SRC, "grafx_tpu/ops/ballistics_tpu.py:35"),
}
# the natural-layout experiment computes #7's function: the same kernel replaces it
LAYOUT_ROW = ("ballistics_core", GAIN_SRC, "benchmarks/ballistics_layout_ab.py:36")
SERVE_KERNELS = ("ballistics_gain_pair_core", "ballistics_gain_core")
TRAIN_KERNELS = ("ballistics_gain_pair_fwd", "ballistics_gain_pair_bwd",
                 "ballistics_gain_fwd", "ballistics_gain_bwd")
STREAM_KERNELS = ("ballistics_core",)
MAX_ABS = 2e-5  # the bound benchmarks/verify_ballistics_tpu.py uses on the TPU
DU_REL = 1e-5  # du: max abs error <= DU_REL * max |ref|
GRAD_REL = 1e-4  # per-row gradients: max abs error <= GRAD_REL * max |ref|
BATCH, CHAINS, AUDIO_LEN = 4, 17, 2**17
BLOCK_LEN, SAMPLE_RATE = 4096, 44100


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


def console_input(shape, generator, device):
    """Noise with quiet passages (-40 dB in half of 32 blocks), so that
    the gates and the compressors' knees act and have gradients."""
    block = shape[-1] // 32
    x = torch.randn(shape, generator=generator, device=device)
    loud = torch.rand(shape[:-2] + (1, 32), generator=generator, device=device) < 0.5
    return x * torch.where(loud, 1.0, 0.01).repeat_interleave(block, dim=-1)


def device_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_err(got, ref):
    return (got - ref).abs().max().item()


class KernelCase:
    """One call of a kernel pair (primal-only #1/#2, or forward #3/#5 with
    its adjoint #4/#6) with its plain versions on the same inputs."""

    def __init__(self, pair, u, consts, kinds, inits, gg):
        self.pair, self.u, self.consts, self.gg = pair, u, consts, gg
        self.kinds, self.inits = kinds, inits

    def _kw(self, inits=True):
        if not self.pair:
            return {"kind": self.kinds}
        return {"kinds": self.kinds, "inits": self.inits} if inits else {"kinds": self.kinds}

    def primal(self, plain=False):
        fn = ((bal.ballistics_gain_pair_plain if plain else bal.ballistics_gain_pair_core)
              if self.pair else (bal.ballistics_gain_plain if plain else bal.ballistics_gain_core))
        return fn(self.u, *self.consts, **self._kw())

    def forward(self, plain=False):
        fn = ((bal.ballistics_gain_pair_fwd_plain if plain else bal.ballistics_gain_pair_fwd)
              if self.pair else (bal.ballistics_gain_fwd_plain if plain else bal.ballistics_gain_fwd))
        return fn(self.u, *self.consts, **self._kw())

    def backward(self, res, plain=False):
        """The adjoint on the residuals ``res`` of a forward."""
        if self.pair:
            fn = bal.ballistics_gain_pair_bwd_plain if plain else bal.ballistics_gain_pair_bwd
            return fn(self.u, *res[1:], self.gg, *self.consts, **self._kw(inits=False))
        fn = bal.ballistics_gain_bwd_plain if plain else bal.ballistics_gain_bwd
        return fn(self.u, res[1], res[2], self.gg, *self.consts[1:], **self._kw())

    @property
    def names(self):
        fwd = "ballistics_gain_pair_fwd" if self.pair else "ballistics_gain_fwd"
        return ("ballistics_gain_pair_core" if self.pair else "ballistics_gain_core",
                fwd, fwd.replace("_fwd", "_bwd"))


def kernel_cases(gen, length=2**13):
    """Cases at small shapes: N = 68, 8 and 37 rows, both kinds, a
    one-pole member with init 0, absent members; (label, case, absent
    rows per member)."""
    cases = []
    for n in (68, 8, 37):
        u = energy(gen, n, length)
        gg = torch.randn(n, length, generator=gen, device="cuda")
        for kind in ("compressor", "noisegate"):
            zi = torch.rand(n, generator=gen, device="cuda")
            absent = torch.arange(n, device="cuda") % 5 == 0
            c = [zi] + gain_consts(gen, n, kind, absent=absent)
            cases.append((f"N={n} {kind}", KernelCase(False, u, c, kind, None, gg), (absent,)))
        for kinds, inits in ((("noisegate", "compressor"), (0.0, 1.0)),
                             (("compressor", "noisegate"), (1.0, 1.0))):
            absent = torch.arange(n, device="cuda") % 3 != 0
            c = gain_consts(gen, n, kinds[0], onepole=inits[0] == 0.0, absent=absent)
            c += gain_consts(gen, n, kinds[1])
            cases.append((f"N={n} {'/'.join(kinds)} inits={inits}",
                          KernelCase(True, u, c, kinds, inits, gg), (absent, None)))
    return cases


def console_cases(gen):
    """The console's two calls: the 17 gate -> compressor composites at
    batch 4 (68 rows; 11 of every 17 gates absent) and the two bus
    compressors at batch 4 (8 rows), over 2^17 samples."""
    n = BATCH * CHAINS
    absent = (torch.arange(n, device="cuda") % CHAINS) % 3 != 0
    u = energy(gen, n, AUDIO_LEN)
    c = gain_consts(gen, n, "noisegate", onepole=True, absent=absent) + gain_consts(gen, n, "compressor")
    gg = torch.randn(n, AUDIO_LEN, generator=gen, device="cuda")
    pair = KernelCase(True, u, c, ("noisegate", "compressor"), (0.0, 1.0), gg)
    n = BATCH * 2
    u2 = energy(gen, n, AUDIO_LEN)
    c2 = [torch.ones(n, device="cuda")] + gain_consts(gen, n, "compressor")
    gg2 = torch.randn(n, AUDIO_LEN, generator=gen, device="cuda")
    return [pair, KernelCase(False, u2, c2, "compressor", None, gg2)]


def grad_names(case):
    if case.pair:
        return [f"d{p}_{m}" for m in "ab" for p in ("at", "rt", "th", "cf", "hk")]
    return ["dzi", "dat", "drt", "dth", "dcf", "dhk"]


def check_case(label, case, stats, absent=None, timed=False):
    """Hold the primal kernel, the forward and the adjoint against their
    plain versions.  With ``timed``, each plain version's one run is
    timed, then each kernel over 5 runs after a warm-up."""
    prim_name, fwd_name, bwd_name = case.names

    def plain(name, fn):
        if not timed:
            return fn()
        ms, out = device_ms(fn, reps=1)
        stats[name]["plain_ms"] = ms
        return out

    prim, fwd = case.primal(), case.forward()
    bwd = case.backward(fwd)
    prim_ref = plain(prim_name, lambda: case.primal(plain=True))
    fwd_ref = plain(fwd_name, lambda: case.forward(plain=True))
    # the kernel's residuals for both: #4/#6 alone
    bwd_ref = plain(bwd_name, lambda: case.backward(fwd, plain=True))
    torch.cuda.synchronize()

    err = max_err(prim, prim_ref)
    check(err < MAX_ABS, f"{prim_name} {label}: max abs err {err} >= {MAX_ABS}")
    stats[prim_name]["max_abs_err"] = max(stats[prim_name]["max_abs_err"], err)
    check(torch.equal(fwd[0], prim), f"{fwd_name} {label}: the gain differs from {prim_name}'s")
    ferr = max(max_err(a, b) for a, b in zip(fwd, fwd_ref))
    check(ferr < MAX_ABS, f"{fwd_name} {label}: gain/residual max abs err {ferr} >= {MAX_ABS}")
    stats[fwd_name]["max_abs_err"] = max(stats[fwd_name]["max_abs_err"], ferr)

    du_err, du_scale = max_err(bwd[0], bwd_ref[0]), bwd_ref[0].abs().max().item()
    check(du_err <= DU_REL * du_scale, f"{bwd_name} {label}: du err {du_err} > {DU_REL} x {du_scale}")
    rel = 0.0
    for name, g, r in zip(grad_names(case), bwd[1:], bwd_ref[1:]):
        e, scale = max_err(g, r), r.abs().max().item()
        check(e <= GRAD_REL * scale, f"{bwd_name} {label} {name}: err {e} > {GRAD_REL} x {scale}")
        rel = max(rel, e / scale if scale > 0 else 0.0)
        stats[bwd_name]["max_abs_err"] = max(stats[bwd_name]["max_abs_err"], e)
    stats[bwd_name]["max_abs_err"] = max(stats[bwd_name]["max_abs_err"], du_err)
    if absent is not None:
        # an absent member (cf = 0) gets no gradient through its walk or
        # knee; dcf is the cotangent of the masked cf, which the mask zeroes
        for m, rows in zip(("a", "b") if case.pair else ("",), absent):
            if rows is None:
                continue
            for name, g in zip(grad_names(case), bwd[1:]):
                if name.endswith(m) and not name.startswith("dcf"):
                    check(bool((g[rows] == 0).all()), f"{bwd_name} {label}: absent {name} != 0")
            if not case.pair:
                check(bool((bwd[0][rows] == 0).all()), f"{bwd_name} {label}: absent du != 0")
    say("kernels", case=label, primal_err=f"{err:.3g}", fwd_err=f"{ferr:.3g}",
        du_err=f"{du_err:.3g}", du_scale=f"{du_scale:.3g}", grad_rel_err=f"{rel:.3g}")
    if timed:
        for name, kern in ((prim_name, case.primal), (fwd_name, case.forward),
                           (bwd_name, lambda: case.backward(fwd))):
            kern()  # warm-up
            stats[name]["ms"] = device_ms(kern, reps=5)[0]
            say("kernels", kernel=name, shape=tuple(case.u.shape),
                kernel_ms=f"{stats[name]['ms']:.3f}", plain_ms=f"{stats[name]['plain_ms']:.1f}")


def check_walk(label, u, zi, at, rt, stats, timed=False):
    """Hold kernel #7 against its plain version, and the walk split in
    two halves (the second from the first's last sample) against one
    walk, bit for bit.  With ``timed``, the plain version's one run and
    the kernel over 5 runs after a warm-up are timed."""
    name = "ballistics_core"
    y = bal.ballistics_core(u, zi, at, rt)
    if timed:
        stats[name]["plain_ms"], ref = device_ms(lambda: bal.ballistics_plain(u, zi, at, rt), reps=1)
    else:
        ref = bal.ballistics_plain(u, zi, at, rt)
    half = u.shape[1] // 2
    first = bal.ballistics_core(u[:, :half], zi, at, rt)
    second = bal.ballistics_core(u[:, half:], first[:, -1], at, rt)
    torch.cuda.synchronize()
    err = max_err(y, ref)
    check(err < MAX_ABS, f"{name} {label}: max abs err {err} >= {MAX_ABS}")
    check(torch.equal(torch.cat([first, second], dim=1), y),
          f"{name} {label}: the walk split at {half} differs from one walk")
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    say("kernels", case=f"{name} {label}", err=f"{err:.3g}", split_at=half, state_carry="exact")
    if timed:
        bal.ballistics_core(u, zi, at, rt)  # warm-up
        stats[name]["ms"] = device_ms(lambda: bal.ballistics_core(u, zi, at, rt), reps=5)[0]
        say("kernels", kernel=name, shape=tuple(u.shape), kernel_ms=f"{stats[name]['ms']:.3f}",
            plain_ms=f"{stats[name]['plain_ms']:.1f}")


def walk_args(gen, n, length):
    """(u, zi, at, rt) on the card for kernel #7."""
    at, rt = gain_consts(gen, n, "compressor")[:2]
    return energy(gen, n, length), torch.rand(n, generator=gen, device="cuda"), at, rt


def db(err, ref):
    return 20.0 * torch.log10(torch.linalg.norm(err) / torch.linalg.norm(ref)).item()


def profile_run(fn, out_dir, name, card):
    """One warm run of ``fn`` under torch.profiler.  The busy time is the
    union of the device ops' intervals; the idle share is the rest of the
    span the CUDA events measure."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ms, _ = device_ms(fn, reps=1)
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
    table = os.path.join(out_dir, f"profile_{name}.txt")
    with open(table, "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    say("profile", run=name, device_ms=f"{ms:.3f}", host_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}", device_ops=len(spans),
        idle_share=f"{max(0.0, 1.0 - busy_ms / ms):.3f}", table=table, card=repr(card))


def stream_phase(args, smi, stats):
    """Phase 9: the console streamed in blocks, against its one-shot render."""
    console = bench_console(CHAINS, seed=0, device="cuda")
    streamer = StreamRenderer(console.fused_processors, console.plan, console.params,
                              block_len=BLOCK_LEN)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = console_input((CHAINS, 2, AUDIO_LEN), g, "cuda")
    x_blocks = list(x.split(BLOCK_LEN, dim=-1))
    state = streamer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.reset_launch_counts()
    outs, block_ms, wall_ms = [], [], []
    with torch.inference_mode():
        for xb in x_blocks:
            t0 = time.perf_counter()
            ms, (y, state) = device_ms(lambda xb=xb, state=state: streamer(xb, state), reps=1)
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            block_ms.append(ms)
            check(y.shape == (1, 2, BLOCK_LEN), f"stream block shape {tuple(y.shape)}")
            outs.append(y)
    launches = bal.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name, count in launches.items():
        if name in STREAM_KERNELS:
            check(count > 0, f"{name} was not launched on the stream path")
            stats[name]["launches"] = count
        else:
            check(count == 0, f"{name} was launched on the stream path")
    streamed = torch.cat(outs, dim=-1)
    check(bool(torch.isfinite(streamed).all()), "non-finite streamed output")
    wall = statistics.median(wall_ms[1:])
    block_s = BLOCK_LEN / SAMPLE_RATE
    say("stream", blocks=len(outs), block_len=BLOCK_LEN,
        block_ms=[round(t, 3) for t in block_ms], host_wall_ms=[round(t, 3) for t in wall_ms],
        warm_median_ms=f"{statistics.median(block_ms[1:]):.3f}", warm_median_wall_ms=f"{wall:.3f}",
        real_time_factor=f"{1e3 * block_s / wall:.2f}", peak_mem_gib=f"{peak_gb:.3f}",
        launches=launches, card=repr(smi))

    with torch.inference_mode():
        full = make_render_fn(console.fused_processors, console.plan)(x, console.params)[0]
        many, _ = streamer.step_many(torch.stack(x_blocks[:4]), streamer.init_state())
    peak_db = 20.0 * torch.log10((streamed - full).abs().max() / full.abs().max()).item()
    check(peak_db <= -60.0, f"stream vs one-shot render at {peak_db:.1f} dB (max-abs/peak) > -60 dB")
    for k, (a, b) in enumerate(zip(outs, many)):
        check(torch.allclose(b, a, rtol=2e-5, atol=2e-6), f"step_many block {k} != single step")
    say("stream", vs_one_shot_db=f"{peak_db:.1f}", step_many_k=len(many), step_many="equal")
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: streamer(x_blocks[-1], state), args.profile, "stream_block", smi)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one more warm request, step and stream block; write their"
                             " tables to DIR")
    args = parser.parse_args()
    t_start = time.perf_counter()

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
    say("build", seconds=f"{lib.build_seconds:.2f}", libraries=list(lib.paths.values()))
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  nvcc:", line.strip(), flush=True)

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    with torch.inference_mode():
        for label, case, absent in kernel_cases(gen):
            check_case(label, case, stats, absent)
        for case in console_cases(gen):
            check_case(f"console {tuple(case.u.shape)}", case, stats, timed=True)
        # #7 at the stream's row counts (17 chain and 2 bus compressors)
        # and more, at a block, a ragged block and a call shorter than its
        # 8-tile ring; timed at the stream's call
        for n in (17, 2, 37, 68):
            for length in (BLOCK_LEN, BLOCK_LEN + 13, 200):
                check_walk(f"N={n} L={length}", *walk_args(gen, n, length), stats)
        check_walk(f"stream call ({CHAINS}, {BLOCK_LEN})", *walk_args(gen, CHAINS, BLOCK_LEN),
                   stats, timed=True)
        big = walk_args(gen, BATCH * CHAINS, AUDIO_LEN)
        bal.ballistics_core(*big)  # warm-up
        big_ms = device_ms(lambda: bal.ballistics_core(*big), reps=5)[0]
        say("kernels", kernel="ballistics_core", shape=tuple(big[0].shape), kernel_ms=f"{big_ms:.3f}")
        del big

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
    bal.reset_launch_counts()
    request_ms = []
    with torch.inference_mode():
        for x in requests:
            ms, (y, _, _) = device_ms(lambda x=x: render(x, console.params), reps=1)
            check(y.shape == (BATCH, 1, 2, AUDIO_LEN), f"output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), "non-finite output")
            request_ms.append(ms)
    launches = bal.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name, count in launches.items():
        if name in SERVE_KERNELS:
            check(count > 0, f"{name} was not launched on the serving path")
            stats[name]["launches"] = count
        else:
            check(count == 0, f"{name} was launched on the serving path")
    say("serve", requests=len(request_ms), request_ms=[round(t, 3) for t in request_ms],
        median_ms=f"{statistics.median(request_ms):.3f}", peak_mem_gib=f"{peak_gb:.2f}",
        launches=launches, card=repr(smi))
    if args.profile:
        with torch.inference_mode():
            profile_run(lambda: render(requests[-1], console.params), args.profile, "request", smi)
    del console, render, requests, y

    # 6. train the full-width console: three gradient steps
    trainer = bench_trainer(CHAINS, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    x = console_input((BATCH, CHAINS, 2, AUDIO_LEN), g, "cuda")
    target = torch.randn(BATCH, 1, 2, AUDIO_LEN, generator=g, device="cuda")
    leaves = tree_items(trainer.params)
    start = {k: p.detach().clone() for k, p in leaves}
    lr = trainer.optimizer.param_groups[0]["lr"]
    largest_step = {k: torch.zeros_like(p) for k, p in leaves if p.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bal.reset_launch_counts()
    step_ms, step_losses = [], []
    for _ in range(3):
        ms, (_, audio) = device_ms(lambda: trainer.step(x, target), reps=1)
        step_ms.append(ms)
        step_losses.append(audio.item())
        for k, p in leaves:
            if p.requires_grad:
                check(p.grad is not None and bool(torch.isfinite(p.grad).all())
                      and bool((p.grad != 0).any()), f"no finite nonzero gradient reached {k}")
                largest_step[k] = torch.maximum(largest_step[k], lr * p.grad.abs())
    launches = bal.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(step_losses)), f"non-finite losses {step_losses}")
    for name, count in launches.items():
        if name in TRAIN_KERNELS:
            check(count > 0, f"{name} was not launched on the training path")
            stats[name]["launches"] = count
        else:
            check(count == 0, f"{name} (no-grad) was launched on the training path")
    moved, frozen, below_ulp = 0, 0, []
    for k, p in leaves:
        same = torch.equal(p.detach(), start[k])
        if k.endswith("_absent"):
            check(same and not p.requires_grad, f"the absent mask {k} changed or trains")
            frozen += 1
        elif not same:
            moved += 1
        else:
            # a leaf may keep its value only where every SGD step was
            # below float32 resolution (half an ulp, within 2x) of it
            resolution = 0.5 * torch.finfo(torch.float32).eps * p.detach().abs()
            check(bool((largest_step[k] <= resolution).all()),
                  f"the trainable leaf {k} did not change, with steps above float32 resolution")
            below_ulp.append(k)
    say("train", steps=len(step_ms), step_ms=[round(t, 3) for t in step_ms],
        warm_median_ms=f"{statistics.median(step_ms[1:]):.3f}", peak_mem_gib=f"{peak_gb:.2f}",
        losses=[f"{v:.6f}" for v in step_losses], leaves_moved=moved,
        leaves_below_float32_step=below_ulp, absent_unchanged=frozen,
        launches=launches, card=repr(smi))
    if args.profile:
        profile_run(lambda: trainer.step(x, target), args.profile, "step", smi)
    del trainer, x, target

    # 7. the card's loss and gradients against the port's CPU path
    g = torch.Generator().manual_seed(4)
    x = console_input((1, CHAINS, 2, 2**14), g, "cpu")
    target = torch.randn(1, 1, 2, 2**14, generator=g)
    losses, grads = {}, {}
    for device in ("cuda", "cpu"):
        tr = bench_trainer(CHAINS, seed=5, device=device)
        total, audio = tr.loss(x.to(device), target.to(device))
        total.backward()
        losses[device] = audio.detach().cpu().double()
        grads[device] = {k: torch.zeros(p.shape) if p.grad is None else p.grad.cpu()
                         for k, p in tree_items(tr.params)}
    loss_db = db(losses["cuda"] - losses["cpu"], losses["cpu"])
    cat = {d: torch.cat([v.ravel() for v in grads[d].values()]) for d in grads}
    grad_db = db(cat["cuda"] - cat["cpu"], cat["cpu"])
    check(bool(torch.isfinite(cat["cuda"]).all()), "non-finite card gradient")
    check(loss_db <= -60.0, f"loss card vs CPU at {loss_db:.1f} dB > -60 dB")
    check(grad_db <= -60.0, f"gradient card vs CPU at {grad_db:.1f} dB > -60 dB")
    worst, worst_leaf, zero_leaves = -1e9, None, 0
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        if bool((ref != 0).any()):
            leaf_db = db(got - ref, ref)
            check(leaf_db <= -40.0, f"gradient of {k} card vs CPU at {leaf_db:.1f} dB > -40 dB")
            if leaf_db > worst:
                worst, worst_leaf = leaf_db, k
        else:
            check(bool((got == 0).all()), f"gradient of {k} is zero on the CPU, not on the card")
            zero_leaves += 1
    say("grad_card_vs_cpu", loss_db=f"{loss_db:.1f}", grad_db=f"{grad_db:.1f}",
        worst_leaf_db=f"{worst:.1f}", worst_leaf=worst_leaf, zero_leaves=zero_leaves,
        leaves=len(grads["cpu"]))

    # 8. the served console, card against the port's CPU path
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

    # 9. stream the full-width console block by block
    stream_phase(args, smi, stats)

    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": stats[name]["launches"], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, source, replaces in [(n, *v) for n, v in KERNELS.items()] + [LAYOUT_ROW]
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
