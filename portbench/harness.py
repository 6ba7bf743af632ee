"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a layer's kernels is found by name under this folder:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric up to its first dot>.py``, ``kernels/*.json``,
``limits/<cell>.json`` and ``reference/<processor class>.py`` (or the
module a processor entry names under ``"reference"``).
"""

import gc
import importlib
import json
import os
import random
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, system, trace, traffic as gen
from portbench.reference import graph

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "grafx_tpu")


def load(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    limits; ``overrides`` replaces configuration keys (the tests' small
    sizes)."""

    def __init__(self, bench, name, overrides=None, limits=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        self.config = {**load(f"configs/{self.spec['config']}.json"), **(overrides or {})}
        self.traffic = load(f"traffic/{self.spec['traffic']}.json")
        self.limits = limits or load(f"limits/{name}.json")
        self.mode = self.traffic["mode"]

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def sizes(self):
        """``{type: {name: size}}`` of the parameters the reference draws."""
        return {t: graph.module(s).parameter_size(s["args"])
                for t, s in self.config["processors"].items()}

    def counts(self):
        out = {}
        for kind in self.config["nodes"]:
            out[kind] = out.get(kind, 0) + 1
        return out


def gpu_or_exit(chips):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")


def fixed_caches(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class Run:
    """The state of one run: the system, its inputs, the window's calls and
    the readings :func:`run_cell` prints."""

    def __init__(self, cell, seed, device, t0, fault=None):
        self.cell, self.seed, self.device, self.t0, self.fault = cell, seed, device, t0, fault
        cfg, tr = cell.config, cell.traffic
        self.batch, self.length, self.sr = cfg["batch"], cfg["length"], cfg["sample_rate"]
        self.shape = (cfg["batch"], cell.counts()["in"], cfg["channels"], cfg["length"])
        self.pool = tr["pool"]
        self.calls = 0
        self.spans = {}
        self.host = None  # the client's pinned buffer a request's mix lands in

    # -- set-up ---------------------------------------------------------

    def build(self):
        start = time.perf_counter()
        import torch._dynamo  # noqa: F401 (torch.optim and torch.compiler import it on first use)

        import grafx_tpu_torch  # noqa: F401 (the imports are set-up, not planning or capture)

        cfg, tr, dev = self.cell.config, self.cell.traffic, self.device
        self.spans["import_s"] = time.perf_counter() - start
        start = time.perf_counter()
        torch.zeros(1, device=dev)  # the device's context, too
        sync(dev)
        self.spans["context_s"] = time.perf_counter() - start
        start = time.perf_counter()
        self.sys = (system.Trainer if self.cell.mode == "train" else system.Served)(cfg, tr, dev)
        self.rows = system.row_nodes(self.sys.G)
        sizes = self.cell.sizes()
        system.check_sizes(self.sys.procs, sizes)
        self.spans["plan_s"] = time.perf_counter() - start
        g = gen.generator(self.seed, dev, 0)
        sets = 1 if self.cell.mode == "train" else self.pool
        start = time.perf_counter()
        self.params = gen.parameters(sizes, self.cell.counts(), sets, cfg["param_std"], g, dev)
        self.x = [gen.stems(tr["stems"], self.shape, g, dev) for _ in range(self.pool)]
        sync(dev)
        self.spans["inputs_s"] = time.perf_counter() - start
        if self.cell.mode == "train":
            self.y = [gen.target(tr["target"], x) for x in self.x]
            start = time.perf_counter()
            self.sys.load(gen.pick(self.params, 0))
            self._faults_train()
        else:
            start = time.perf_counter()
            self.fused = [self.sys.migrate(gen.pick(self.params, i)) for i in range(self.pool)]
        sync(dev)
        self.spans["plan_s"] += time.perf_counter() - start

    def _faults_train(self):
        opt = self.sys.opt
        if self.fault == "unchanged_state":
            opt.optimizer.step = lambda *a, **k: None
        elif self.fault == "half_batch":
            loss = opt.loss_fn
            opt.loss_fn = lambda out, tgt: loss(out[: out.shape[0] // 2], tgt[: tgt.shape[0] // 2])

    def call(self):
        """One timed call: a training step with its loss read, or a request
        with its mix on the host.  Returns the host result."""
        k = self.calls % self.pool
        self.calls += 1
        if self.cell.mode == "train":
            with record_function("portbench.step"):
                loss = self.sys.step(self.x[k], self.y[k])
            with record_function("portbench.loss_read"):
                return k, float(loss)
        with record_function("portbench.request"):
            out = self.sys(self.x[k], self.fused[k])
        with record_function("portbench.readback"):
            if self.host is None:
                self.host = torch.empty(out.shape, dtype=out.dtype,
                                        pin_memory=self.device.type == "cuda")
            self.host.copy_(out, non_blocking=True)
            sync(self.device)
        if self.fault == "altered_answer":
            self.host[0] *= 1.01  # one mix of each request off by 1%
        return k, self.host

    def warm(self):
        """The calls before the window: the eager call and the capture
        (``capture_s``); a training run's first steps are the ones the
        reference follows."""
        start = time.perf_counter()
        calls = []
        if self.cell.mode == "train":
            tr = self.sys
            self.p0 = tr.snapshot()
            self.prog = {"losses": []}
            steps = self.cell.traffic["check_steps"]
            for i in range(max(steps, 3)):
                t = time.perf_counter()
                k, loss = self.call()
                calls.append(time.perf_counter() - t)
                self.prog["losses"].append(loss)
                if i == 0:
                    self.prog["grad"] = tr.leaf_sums(lambda path, p: p.grad)
                if i + 1 == steps:
                    self.prog["change"] = tr.leaf_sums(lambda path, p: p - self.p0[path])
            self.prog["losses"] = self.prog["losses"][:steps]
        else:
            for _ in range(3):
                t = time.perf_counter()
                self.call()
                calls.append(time.perf_counter() - t)
        sync(self.device)
        self.spans["capture_s"] = time.perf_counter() - start
        self.spans["eager_call_s"], self.spans["capturing_call_s"] = calls[0], calls[1]

    # -- the window -----------------------------------------------------

    def window(self, seconds):
        keep = self.cell.traffic.get("check_requests", 0)
        pick = random.Random(self.seed * 31 + 7)
        self.sample, lat = [], []
        start = time.perf_counter()
        self.setup_s = start - self.t0
        n, now = 0, start
        while now - start < seconds:
            k, host = self.call()
            done = time.perf_counter()
            lat.append(done - now)
            if keep:
                if len(self.sample) < keep:
                    self.sample.append((k, host.clone()))
                else:
                    j = pick.randrange(n + 1)
                    if j < keep:
                        self.sample[j] = (k, host.clone())
            n, now = n + 1, done
        self.elapsed = now - start
        self.done = n
        audio = n * self.batch * self.length / self.sr / self.elapsed
        if self.cell.mode == "train":
            self.e2e = {"train_audio_s_per_s": audio}
        else:
            self.e2e = {"serve_audio_s_per_s": audio,
                        "request_p95_ms": 1e3 * float(np.percentile(lat, 95))}
        self.e2e["setup_s"] = self.setup_s

    def traced(self):
        """Per-layer readings from a profiled window of whole calls."""
        calls = self.cell.traffic["trace_calls"]

        def run():
            for _ in range(calls):
                self.call()

        device, host, seconds = trace.window(run)
        flops, walk_bytes = graph.count(self.cell.config, self.batch, self.length,
                                        self.cell.mode == "train")
        peaks = load("peaks.json").get(torch.cuda.get_device_name(0), {})
        ctx = types.SimpleNamespace(
            mode=self.cell.mode, calls=calls, device=device, host=host, window_s=seconds,
            busy_s=trace.busy_us(device) / 1e6, seconds_per_call=self.elapsed / self.done,
            flops=flops, walk_bytes=walk_bytes, peaks=peaks, spans=self.spans,
            layers=trace.kernel_layers(os.path.join(HERE, "kernels")))
        metrics = {}
        for m in self.cell.per_layer:
            reader = importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}")
            value = reader.read(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        self.trace_metrics = metrics
        self.trace_device = {"busy_s": ctx.busy_s, "window_s": seconds}
        self.breakdown = trace.breakdown(device, host)

    # -- correctness ----------------------------------------------------

    def free_program(self):
        """Drop the program's state before the reference runs."""
        for name in ("sys", "fused", "y"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """The inputs the reference needs, kept past :meth:`free_program`."""
        if self.cell.mode == "train":
            steps = self.cell.traffic["check_steps"]
            tgt = self.cell.traffic["target"]
            return [(self.x[k], gen.target(tgt, self.x[k])) for k in range(steps)]
        ks = sorted({k for k, _ in self.sample})
        stems = torch.stack([self.x[k] for k in ks])
        params = {t: {n: v[ks] for n, v in names.items()} for t, names in self.params.items()}
        return ks, stems, params

    def numbers(self, precision="float64", control=None, half_batch=False):
        """``(numbers, notes)``: the program's results (or the run of
        precision ``control`` in their place) against the reference."""
        cfg, ref_p = self.cell.config, check.Precision(precision)
        if self.cell.mode == "train":
            steps = self.ref_inputs
            p0 = gen.pick(self.params, 0)
            lr = self.cell.traffic["optimizer"]["lr"]
            if not hasattr(self, "ref"):
                self.ref = check.train(cfg, steps, p0, self.rows, lr, ref_p)
            prog = self.prog
            if control is not None or half_batch:
                prog = check.train(cfg, steps, p0, self.rows, lr,
                                   check.Precision(control or precision), half_batch=half_batch)
            return check.train_numbers(prog, self.ref)
        ks, stems, params = self.ref_inputs
        if not hasattr(self, "ref"):
            self.ref = check.render(cfg, stems, params, self.rows, ref_p)
        index = {k: i for i, k in enumerate(ks)}
        if control is None:
            outputs = [host for _, host in self.sample]
        else:
            ctl = check.render(cfg, stems, params, self.rows, check.Precision(control))
            outputs = [ctl[index[k]] for k, _ in self.sample]
        refs = [self.ref[index[k]].cpu() for k, _ in self.sample]
        outputs = [o.cpu() for o in outputs]
        return {name: check.output_error(outputs, refs, cfg["sample_rate"], spec.get("above_hz"))
                for name, spec in self.cell.limits.items()}, {}

    def judge(self):
        start = time.perf_counter()
        numbers, self.notes = self.numbers()
        self.checks = {}
        correct = True
        for name, value in numbers.items():
            limit = self.cell.limits[name]["limit"]
            ok = value == value and value <= limit
            correct = correct and ok
            self.checks[name] = {"value": value, "limit": limit}
        self.correct = correct
        self.check_s = time.perf_counter() - start


def card():
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def run_cell(bench, name, seed, seconds, traced, device, t0, overrides=None, fault=None,
             limits=None):
    """One run; returns ``(result dict, stderr lines, the run)``."""
    cell = Cell(bench, name, overrides, limits)
    run = Run(cell, seed, torch.device(device), t0, fault)
    run.build()
    run.warm()
    run.window(seconds)
    if traced:
        run.traced()
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    run.ref_inputs = run.reference_inputs()
    run.free_program()
    run.judge()
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        metrics = run.trace_metrics
    else:
        metrics = {m: {"value": run.e2e[m], "unit": units[m]} for m in units}
    if run.device.type == "cuda":
        kind, limit = card()
    else:
        kind, limit = "cpu", "none"
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.spec["chips"], "memory_peak_bytes": peak, "power_limit_w": limit}
    if traced:
        dev.update(run.trace_device)
    result = {"correct": run.correct, "attempted": run.done, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = run.breakdown
    result["checks"] = run.checks
    lines = [f"card {kind}, power limit {limit} W; {run.done} calls in {run.elapsed:.3f} s;"
             f" set-up {run.setup_s:.3f} s; reference {run.check_s:.3f} s",
             "set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in run.spans.items())]
    if run.notes:
        lines.append("left out of the norms (reference norm under 1e-3 of the median leaf's): "
                     + (", ".join(run.notes["left_out"]) or "none")
                     + "; worst leaf: " + json.dumps(run.notes["worst_leaf"]))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in run.checks.items()]
    return result, lines, run


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
