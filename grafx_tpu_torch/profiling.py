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

Those time the port from outside.  The tracer times it from inside:
spans, counters and device marks at the port's own layer boundaries,
kept in memory and read with the profiler off.

* :func:`tracing` is its only switch (a context manager; off by
  default).  Off, :func:`span` returns one shared no-op after a single
  check, and :func:`mark` and :func:`count` return at once;
* :func:`span` records ``{name, start, end, id, parent, call, attrs}``
  on one host clock (``time.perf_counter_ns``).  The spans under one
  ``grafx.call`` (:class:`~grafx_tpu_torch.render.compiled.CapturedFunction`,
  a call of a compiled entry point), or under one outermost span, share
  ``call``.  While a ``torch.profiler`` session records, a span also
  opens a ``record_function`` of its name, so that it lands in the
  profiler's trace;
* :func:`mark` records a CUDA event on the device's current stream.  In
  a CUDA-graph capture the event becomes a node of the graph and records
  again on every replay, so that device time inside a replayed graph
  has an owner.  Marks of one name in one call pair up, first to second,
  third to fourth, into device intervals; a span given a ``device``
  marks its start and end.  Events map onto the host clock through one
  anchor a device, an event recorded on the idle stream just after a
  synchronisation, at a known host time (taken when tracing turns on;
  the anchor's half width is its error bound).  Events are read after
  the next call's launch, while the device works (a traced signature
  replays two graphs in turn for that), at the latest before their own
  graph replays again, or at :func:`report`; only events that are done
  are read, and those not done when their graph replays again count in
  the counter ``tracing.events_unread``: tracing never waits for the
  device and adds no synchronisation to a call;
* :func:`setup_span` (and :func:`setup_spanned`) records the work done
  once a process or once a signature, tracing on or off: planning
  (``grafx.plan.*``), the kernels' build (``grafx.build.nvcc``) and a
  signature's eager call and capture (``grafx.capture.eager``,
  ``grafx.capture.graph``).  The newest ``SETUP_KEPT`` are kept;
* :func:`report` returns what was recorded as a dict that ``json``
  accepts (spans, set-up spans, device intervals, counters, anchors and
  a summary of each call); :func:`reset` forgets it.

The record is the process's, kept for one thread at a time.

Where the port records what (the names a report holds):

=============================  ==========================================
``grafx.call``                 a compiled entry point's call (``fn``,
                               ``path``: eager, capture or replay), with
                               children ``.key``, ``.trace`` (the
                               tracer's own book-keeping), ``.copy_in``,
                               ``.launch`` (``graph.replay()``) and
                               ``.clone_out``
``grafx.call.copy_in``,       device intervals of a replay: its
``grafx.call.graph``,          copy-in, its graph from first node to
``grafx.call.clone_out``       last, and its outputs' clones
``grafx.render.precompute``    a type's precompute (``type``), span and
                               device interval
``grafx.render.stage``         a stage (``index``, ``node_type``,
                               ``nodes``), span and device interval,
                               with children ``.read`` (reads and
                               aggregations), ``.process`` (the
                               processor's call; span and device
                               interval) and ``.write``
``grafx.step.backward``        an optimizer step's loss, backward and
                               update (span and device interval)
``grafx.dynamics.frame``       a ``FactorizedCompressor``'s frame
                               smoother: the pooling, the frame walk and
                               the lerp back to the sample rate, and where
                               the frame gain op runs them, the knee too
                               (span and device interval; a step's
                               forward)
counters                       ``grafx.call.eager``, ``.captures``,
                               ``.replays``, ``.bytes_in``;
                               ``ballistics.<wrapper>``: kernel launches,
                               a replay's counted from its capture;
                               ``ballistics.frame.frames``: frames the
                               frame smoothers walk (rows x frames);
                               ``ballistics.frame.fused``: those the
                               frame gain op walks;
                               ``grafx.dynamics.composed``: runs of a
                               fused dynamics chain of two or more
                               members that compose their members' gains
                               (neither the pair walk nor the dynamics
                               chain)
=============================  ==========================================
"""

import collections
import contextlib
import functools
import glob
import itertools
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


# ---------------------------------------------------------------------------
# The tracer (module docstring)
# ---------------------------------------------------------------------------

SETUP_KEPT = 1024  # set-up spans kept, the newest
_CALL = "grafx.call"


class _Log:
    """What the tracer has recorded since the last :func:`reset`."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.stack = []  # open spans, innermost last
        self.spans = []  # finished spans recorded while tracing was on
        self.setup = collections.deque(maxlen=SETUP_KEPT)
        self.counters = {}
        self.pending = []  # (call, [(name, attrs, event, device index)]) not read yet
        self.points = []  # read marks: {name, t, call, attrs}
        self.anchors = {}  # device index -> (event, host ns, error bound ns)
        self.mark_ns = {}  # call -> host ns its marks took
        self.sink = None  # the record of the capture that runs, if one does


_log = _Log()
_depth = 0  # nesting of tracing(); tracing is on while it is positive


class _NoSpan:
    """The span returned while tracing is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "device", "setup", "id", "parent", "call", "start", "end",
                 "_rf")

    def __init__(self, name, attrs, device=None, setup=False):
        self.name, self.attrs, self.device, self.setup = name, attrs, device, setup

    def set(self, **attrs):
        """Add attributes to the span (its path, once it is known)."""
        self.attrs.update(attrs)

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9

    def __enter__(self):
        log = _log
        parent = log.stack[-1] if log.stack else None
        self.id = next(log.ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None and self.name != _CALL else self.id
        log.stack.append(self)
        self._rf = None
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.device is not None:
            mark(self.name, self.device, **self.attrs)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.device is not None:
            mark(self.name, self.device)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        log = _log
        if log.stack and log.stack[-1] is self:
            log.stack.pop()
        elif self in log.stack:  # a span left open inside this one
            log.stack.remove(self)
        record = {"name": self.name, "start": self.start, "end": self.end, "id": self.id,
                  "parent": self.parent, "call": self.call, "attrs": self.attrs}
        if self.setup:
            log.setup.append(record)
        if _depth:
            log.spans.append(record)
        return False


def enabled():
    """Whether tracing is on."""
    return _depth > 0


def span(name, device=None, **attrs):
    """A span of host time (module docstring), to use in a ``with``.
    With ``device`` (a CUDA device) it also marks the device's stream at
    its start and its end, which makes a device interval of the same
    name.  While tracing is off: the shared no-op."""
    if not _depth:
        return _NO_SPAN
    return _Span(name, attrs, device)


def setup_span(name, **attrs):
    """A span of work done once a process or a signature: recorded
    whether tracing is on or off (module docstring).  Its ``seconds``
    are read after the ``with``."""
    return _Span(name, attrs, setup=True)


def setup_spanned(name):
    """Decorate a function so that each of its calls is a
    :func:`setup_span` of ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with setup_span(name):
                return fn(*args, **kwargs)

        return spanned

    return wrap


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on.  Inside a
    capture that :class:`~grafx_tpu_torch.render.compiled.CapturedFunction`
    makes, tracing on or off, the count is the graph's instead, added at
    each traced replay."""
    log = _log
    if log.sink is not None:
        log.sink.counts[name] = log.sink.counts.get(name, 0) + n
    elif _depth:
        log.counters[name] = log.counters.get(name, 0) + n


def _current_call():
    return _log.stack[-1].call if _log.stack else None


def mark(name, device, **attrs):
    """Mark ``device``'s current stream (a CUDA device; nothing
    otherwise) with an event named ``name`` while tracing is on (module
    docstring).  Inside a capture that :class:`~grafx_tpu_torch.render.
    compiled.CapturedFunction` makes, the event is the graph's, read at
    each replay; inside any other capture no mark is made."""
    if not _depth or device is None:
        return
    device = torch.device(device)
    if device.type != "cuda":
        return
    index = torch.cuda.current_device() if device.index is None else device.index
    log = _log
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and log.sink is None:
        return
    if index not in log.anchors:
        if capturing:
            return
        log.anchors[index] = _anchor(index)
    start = time.perf_counter_ns()
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record(torch.cuda.current_stream(index))
    entry, call = (name, attrs, event, index), _current_call()
    if capturing:
        log.sink.marks.append(entry)
    else:
        log.pending.append((call, [entry]))
    log.mark_ns[call] = log.mark_ns.get(call, 0) + time.perf_counter_ns() - start


def _anchor(index):
    """``(event, host ns, error bound ns)``: an event recorded on the
    idle stream right after a synchronisation, timed on the host from
    just before the record to the event's completion; the tightest of
    three, placed at the middle of its window."""
    stream = torch.cuda.current_stream(index)
    best = None
    for _ in range(3):
        torch.cuda.synchronize(index)
        event = torch.cuda.Event(enable_timing=True)
        before = time.perf_counter_ns()
        event.record(stream)
        event.synchronize()
        width = time.perf_counter_ns() - before
        if best is None or width < best[2]:
            best = (event, before, width)
    event, before, width = best
    return event, before + width // 2, width // 2


class Capture:
    """What a capture recorded for its replays: its device ``marks`` and
    its ``counts`` (the kernel wrappers' launches)."""

    __slots__ = ("marks", "counts")

    def __init__(self):
        self.marks, self.counts = [], {}


@contextlib.contextmanager
def capture_marks():
    """Collect the marks and counts made inside the enclosed CUDA-graph
    capture; yields their :class:`Capture`, which :func:`replay_starts`
    and :func:`replay_launched` take at each replay."""
    log = _log
    outer, log.sink = log.sink, Capture()
    try:
        yield log.sink
    finally:
        log.sink = outer


def replay_starts(capture):
    """Before a captured graph launches, while tracing is on: read its
    marks from its last replay if they are done, else count them
    unread, since this replay records them again."""
    if _depth:
        _drain(_log, capture.marks)


def replay_launched(capture):
    """After a captured graph launched, while tracing is on: book its
    marks for the current call, add the counts its capture made, and
    read every other pending mark that is done (this host work overlaps
    the graph's device work)."""
    if not _depth:
        return
    log = _log
    _drain(log)
    if capture.marks:
        log.pending.append((_current_call(), capture.marks))
    for name, n in capture.counts.items():
        count(name, n)


def _unread(log, entries):
    if entries:
        log.counters["tracing.events_unread"] = (
            log.counters.get("tracing.events_unread", 0) + len(entries))


def _drain(log, only=None):
    """Read the pending marks whose events are done, all of them or only
    the list ``only`` (a graph's), which is then dropped either way, not
    done counted unread.  A list counts as done when its last event is
    (the events of one list are recorded in order on one stream)."""
    keep = []
    for call, entries in log.pending:
        if only is not None and entries is not only:
            keep.append((call, entries))
        elif entries[-1][2].query():
            for name, attrs, event, index in entries:
                anchor, host, _ = log.anchors[index]
                t = host + round(anchor.elapsed_time(event) * 1e6)
                log.points.append({"name": name, "t": t, "call": call, "attrs": attrs})
        elif only is not None:
            _unread(log, entries)
        else:
            keep.append((call, entries))
    log.pending = keep


@contextlib.contextmanager
def tracing():
    """Turn tracing on inside the block (nested blocks nest).  On
    entry, the events still pending are read (those not done are counted
    unread) and the current CUDA device, where one is in use, is anchored
    anew (one synchronisation; another device at its first mark)."""
    global _depth
    if not _depth:
        _drain(_log)
        _unread(_log, [e for _, entries in _log.pending for e in entries])
        _log.pending = []
        _log.anchors.clear()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            index = torch.cuda.current_device()
            _log.anchors[index] = _anchor(index)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def reset():
    """Forget everything recorded (set-up spans, counters and pending
    marks too)."""
    global _log
    _log = _Log()


def _intervals(points):
    """Pair the marks of one name in one call, in time order, first to
    second, third to fourth: ``(intervals, unpaired marks)``.  An
    interval takes its opening mark's attributes."""
    groups = {}
    for p in sorted(points, key=lambda p: p["t"]):
        groups.setdefault((p["call"], p["name"]), []).append(p)
    intervals, single = [], []
    for (call, name), ps in groups.items():
        for a, b in zip(ps[0::2], ps[1::2]):
            intervals.append({"name": name, "start": a["t"], "end": b["t"], "call": call,
                              "attrs": {**b["attrs"], **a["attrs"]}})
        if len(ps) % 2:
            single.append(ps[-1])
    intervals.sort(key=lambda i: i["start"])
    return intervals, single


def _ms(ns):
    return ns / 1e6


# a replay's device intervals: the device works for the call inside them
_CALL_PARTS = ("grafx.call.copy_in", "grafx.call.graph", "grafx.call.clone_out")


def _merged(pairs):
    """Sorted ``(start, end)`` pairs merged into disjoint ``[start, end]``."""
    out = []
    for start, end in sorted(pairs):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _summaries(spans, intervals, mark_ns):
    """One summary a ``grafx.call`` span, host and device times in ms;
    ``None`` where the call has no such part (no launch off a replay, no
    device interval off the card).  Host: ``host_ms`` (the call),
    ``launch_ms`` (``graph.replay()``), ``tracing_ms`` (the tracer's own
    work: its ``grafx.call.trace`` spans and the call's marks,
    ``mark_ns``), ``entry_ms`` (the rest), ``host_parts_ms`` (each child span's
    name and ms, summed).  Device: ``device`` (ns, the first
    to the last of the replay's copy-in, graph and clones), ``busy``
    (those intervals, merged), ``launch_wait_ms`` (from the copy-in's end
    to the graph's first node), ``stage_ms``, ``process_ms`` (by
    ``node_type`` in ``process_ms_by_type``), ``executor_ms`` (stages less
    processors), ``precompute_ms`` and ``backward_ms``."""
    children = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    device = {}
    for i in intervals:
        device.setdefault(i["call"], []).append(i)
    out = []
    for s in spans:
        if s["name"] != _CALL:
            continue
        own = {}
        for c in children.get(s["id"], []):
            own[c["name"]] = own.get(c["name"], 0.0) + _ms(c["end"] - c["start"])
        ivs = device.get(s["call"], [])

        def total(name, ivs=ivs):
            return sum(_ms(i["end"] - i["start"]) for i in ivs if i["name"] == name)

        host = _ms(s["end"] - s["start"])
        launch_ms = own.get("grafx.call.launch")
        trace_ms = own.get("grafx.call.trace", 0.0) + _ms(mark_ns.get(s["call"], 0))
        parts = _merged([(i["start"], i["end"]) for i in ivs if i["name"] in _CALL_PARTS])
        copy_in = [i for i in ivs if i["name"] == "grafx.call.copy_in"]
        graph = [i for i in ivs if i["name"] == "grafx.call.graph"]
        by_type = {}
        for i in ivs:
            if i["name"] == "grafx.render.stage.process":
                t = i["attrs"].get("node_type")
                by_type[t] = by_type.get(t, 0.0) + _ms(i["end"] - i["start"])
        stage, process = total("grafx.render.stage"), total("grafx.render.stage.process")
        staged = any(i["name"] == "grafx.render.stage" for i in ivs)
        out.append({
            "call": s["call"], "fn": s["attrs"].get("fn"), "path": s["attrs"].get("path"),
            "start": s["start"], "end": s["end"], "host_ms": host, "launch_ms": launch_ms,
            "tracing_ms": trace_ms,
            "entry_ms": host - launch_ms - trace_ms if launch_ms is not None else None,
            "host_parts_ms": own,
            "device": [parts[0][0], parts[-1][1]] if parts else None,
            "device_ms": _ms(parts[-1][1] - parts[0][0]) if parts else None,
            "busy": parts,
            "launch_wait_ms": (_ms(graph[0]["start"] - copy_in[0]["end"])
                               if graph and copy_in else None),
            "stage_ms": stage if staged else None,
            "process_ms": process if staged else None,
            "executor_ms": stage - process if staged else None,
            "process_ms_by_type": by_type,
            "precompute_ms": total("grafx.render.precompute") if staged else None,
            "backward_ms": total("grafx.step.backward") or None,
        })
    return out


def report():
    """What the tracer has recorded, as a dict that ``json.dumps``
    accepts (times in ns of ``time.perf_counter_ns``; summaries in ms).
    Pending marks whose events are done are read first; none is waited
    for."""
    log = _log
    _drain(log)
    intervals, single = _intervals(log.points)
    return {
        "clock": "time.perf_counter_ns",
        "spans": list(log.spans),
        "setup": list(log.setup),
        "device": intervals,
        "marks": single,
        "counters": dict(log.counters),
        "anchors": {str(i): {"error_bound_us": err / 1e3}
                    for i, (_, _, err) in log.anchors.items()},
        "calls": _summaries(log.spans, intervals, log.mark_ns),
    }
