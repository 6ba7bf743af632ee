"""Profiling helpers (the port of :mod:`grafx_tpu.profiling`) on
``torch.profiler`` and CUDA events.

* :func:`trace` writes a Chrome trace of the enclosed block, host and
  card (open it in ``chrome://tracing`` or Perfetto);
* :func:`device_time_ms` is the device time of a call: the sum of the
  durations of the CUDA kernels, copies and fills it ran (a sum, as
  ``grafx_tpu`` sums its leaf XLA ops: two kernels that overlap count
  twice), checked for events the profiler lost.  On the CPU it sums the
  self time of the leaf CPU ops instead;
* :func:`trace_device_total_ms` reads the same sum from a trace that
  :func:`trace` wrote;
* :func:`time_fn` is the mean seconds of a call after a warm-up, timed by
  CUDA events where the arguments are on the card.
"""

import contextlib
import glob
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

# trace-event categories of work on the card in a Chrome trace from torch.profiler
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Seconds of idle kept at each end of a profiled window, tried in turn.
# The profiler drops device events it places outside its window, and the
# longer a process has run, the wider the margin it needs: on the H100,
# after minutes of work, a short call's events were lost from windows
# with margins of tens of milliseconds, and seldom from 0.5 s ones.
_MARGINS_S = (0.05, 0.2, 0.8, 3.2)
# torch.cuda._sleep's kernel, launched just before and just after the
# profiled call: both present means no event of the call fell outside
_MARKER = "spin_kernel"


@contextlib.contextmanager
def _window(margin, activities):
    """A ``torch.profiler`` session around the enclosed block with
    ``margin`` seconds at both ends, the card idle at its start; yields
    the profiler."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()  # work queued before the block is not the block's
    with profile(activities=activities) as prof:
        time.sleep(margin)
        yield prof
        if cuda:
            torch.cuda.synchronize()
        time.sleep(margin)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the enclosed block, host and card, and write its Chrome
    trace to ``log_dir/trace_<ns>.json`` (a new temporary directory when
    ``None``); yields ``log_dir``.  The card's events of a block that runs
    minutes into a process may fall outside the window and be missing
    (``_MARGINS_S``); :func:`device_time_ms` checks for that."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="grafx_trace_")
    os.makedirs(log_dir, exist_ok=True)
    with _window(_MARGINS_S[0], _activities()) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def trace_device_total_ms(log_dir):
    """The summed duration (ms) of the device events (kernels, copies,
    fills) in the newest trace that :func:`trace` wrote under
    ``log_dir``."""
    paths = glob.glob(os.path.join(log_dir, "**", "trace_*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace_*.json under {log_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        events = json.load(f)["traceEvents"]
    total_us = sum(
        float(e.get("dur", 0.0))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES
    )
    return total_us / 1e3


def device_time_ms(run, log_dir=None):
    """Device milliseconds of ``run()`` (a callable with no arguments that
    does the work): the sum of the durations of the device events it ran,
    or on the CPU the leaf ops' self time.  On the card a marker kernel
    runs just before and just after ``run()``; where the profiler lost
    either, ``run()`` is profiled again with wider margins
    (``_MARGINS_S``), and a ``RuntimeError`` is raised where the widest
    lost one.  With ``log_dir`` the trace is also written there."""
    if not torch.cuda.is_available():
        with _window(0.0, _activities()) as prof:
            run()
        events = prof.events()
        ms = sum(e.self_cpu_time_total for e in events if not e.cpu_children) / 1e3
    else:
        for margin in _MARGINS_S:
            with _window(margin, [ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                run()
                torch.cuda._sleep(1)
            device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if sum(_MARKER in e.name for e in device) == 2:
                break
        else:
            raise RuntimeError(
                f"the profiler lost device events of the call with {_MARGINS_S[-1]} s margins"
            )
        ms = sum(e.time_range.elapsed_us() for e in device if _MARKER not in e.name) / 1e3
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
    return ms


def time_fn(fn, *args, iters=10, vary=True, **kwargs):
    """Mean seconds per call of ``fn(*args, **kwargs)`` over ``iters``
    calls after one warm-up call, by CUDA events where the first tensor
    argument is on the card and by the host clock otherwise.

    With ``vary`` each call gets its own first argument, scaled by ``1 +
    i * 1e-6`` (made before the timing starts), so that no two calls see
    the same input, as ``grafx_tpu``'s does."""
    if vary:
        base = args[0]
        inputs = [(base * (1.0 + i * 1e-6),) + args[1:] for i in range(iters + 1)]
    else:
        inputs = [args] * (iters + 1)
    tensor = next((a for a in args if isinstance(a, torch.Tensor)), None)
    on_card = tensor is not None and tensor.is_cuda
    fn(*inputs[0], **kwargs)
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for a in inputs[1:]:
            fn(*a, **kwargs)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for a in inputs[1:]:
        fn(*a, **kwargs)
    return (time.perf_counter() - t0) / iters
