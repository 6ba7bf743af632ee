"""The traced window of a run: ``torch.profiler`` over a few whole calls,
and its reduction to device events, the busy time and a breakdown.

The profiler window and its marker check are a frozen copy of
``grafx_tpu_torch/profiling.py`` (``_window``, ``device_time_ms``): the
card idles for a margin at each end, and ``torch.cuda._sleep``'s kernel
runs just before and just after the calls; where the profiler lost
either marker, the window is taken again with a wider margin.
"""

import json
import os
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

MARGINS_S = (0.05, 0.2, 0.8)
MARKER = "spin_kernel"


def window(run):
    """Profile ``run()`` (host and card): ``(device, host, seconds)`` with
    the device and host events as ``[(name, start_us, dur_us)]`` and the
    host seconds ``run()`` took, synchronised."""
    for margin in MARGINS_S:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            torch.cuda._sleep(1)
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(margin)
        device, host = [], []
        for e in prof.events():
            item = (e.name, e.time_range.start, e.time_range.elapsed_us())
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(item)
            elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")):
                device.append(item)  # a span's mirror on the device's timeline is no operation
        if sum(MARKER in name for name, _, _ in device) == 2:
            return [d for d in device if MARKER not in d[0]], host, seconds
    raise RuntimeError(f"the profiler lost device events with {MARGINS_S[-1]} s margins")


def intervals(events):
    """The union of ``[(name, start, dur)]`` as sorted disjoint intervals."""
    merged = []
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_us(events):
    return sum(end - start for start, end in intervals(events))


def short(name, width=96):
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(device, host, top=10):
    """The device operations that took most time, and the longest idle
    gaps between device operations, each named by the innermost host
    event under its middle."""
    by_name = {}
    for name, _, dur in device:
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    spans = intervals(device)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        mid = (end + start) / 2
        under = [h for h in host if h[1] <= mid <= h[1] + h[2]]
        name = min(under, key=lambda h: h[2])[0] if under else "no host event"
        gaps.append((short(name), (start - end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def kernel_layers(folder):
    """``{layer: (include regexes, exclude regexes)}`` from every
    ``kernels/*.json`` (``{"layer", "patterns", "exclude"}``), merged by
    layer."""
    layers = {}
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(folder, fname)) as f:
            spec = json.load(f)
        inc, exc = layers.setdefault(spec["layer"], ([], []))
        inc += [re.compile(p) for p in spec["patterns"]]
        exc += [re.compile(p) for p in spec.get("exclude", [])]
    return layers


def matching(device, layer):
    inc, exc = layer
    return [e for e in device
            if any(p.search(e[0]) for p in inc) and not any(p.search(e[0]) for p in exc)]
