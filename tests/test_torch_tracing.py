"""The tracer in ``grafx_tpu_torch.profiling``: spans, counters, device
marks and the report.  On the CPU: nesting, the off path, the profiler's
mirror, the executor's stages, the set-up spans, the report's pairing and
summaries, and the kernel wrappers' launch counts.  The tests marked
``card`` need an NVIDIA card and skip without one; run them there with
``python -m pytest --noconftest -m card tests/test_torch_tracing.py``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine lacks)."""

import json
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grafx_tpu_torch import profiling
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_graph, bench_processors
from grafx_tpu_torch.ops import ballistics
from grafx_tpu_torch.processors import FactorizedCompressor, StereoGain, TanhDistortion
from grafx_tpu_torch.render import (
    CapturedFunction,
    FusedDynamicsChain,
    fuse_parameters,
    fuse_serial_lti,
    make_render_fn,
    prepare_render,
    render_grafx,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import create_empty_parameters


@pytest.fixture(autouse=True)
def fresh_log():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


def small_graph():
    """Three chains in -> gain -> dist into a mix, then out."""
    G = GRAFX(config=NodeConfigs(["gain", "dist"]))
    ends = [G.add_serial_chain(["in", "gain", "dist"])[-1] for _ in range(3)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


def small_render(device="cpu"):
    G = small_graph()
    procs = {"gain": StereoGain(), "dist": TanhDistortion()}
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(procs, G, generator=torch.Generator().manual_seed(0))
    params = {t: {k: v.to(device) for k, v in p.items()} for t, p in params.items()}
    return procs, plan, params


def named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_spans_nest_with_parent_and_call_ids():
    with profiling.tracing():
        with profiling.span("outer", k=1) as outer:
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("grafx.call") as call:
                with profiling.span("grafx.call.key"):
                    pass
        with profiling.span("next"):
            pass
    spans = {s["name"]: s for s in profiling.report()["spans"]}
    assert spans["outer"]["parent"] is None and spans["outer"]["call"] == outer.id
    assert spans["outer"]["attrs"] == {"k": 1}
    assert spans["inner"]["parent"] == outer.id and spans["leaf"]["parent"] == spans["inner"]["id"]
    assert spans["leaf"]["call"] == spans["inner"]["call"] == outer.id
    # a port's call opens a call of its own, under its parent
    assert spans["grafx.call"]["parent"] == outer.id and spans["grafx.call"]["call"] == call.id
    assert spans["grafx.call.key"]["call"] == call.id
    assert spans["next"]["call"] == spans["next"]["id"] != outer.id
    for s in spans.values():
        assert s["start"] <= s["end"]
    assert spans["outer"]["start"] <= spans["inner"]["start"] <= spans["leaf"]["end"] \
        <= spans["inner"]["end"] <= spans["outer"]["end"]


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not profiling.enabled()
    first, second = profiling.span("a", k=1), profiling.span("b", torch.device("cpu"))
    assert first is second
    with first as s:
        s.set(path="replay")
    profiling.count("c", 3)
    profiling.mark("m", torch.device("cpu"))
    procs, plan, params = small_render()
    render_grafx(procs, torch.randn(3, 2, 256), params, plan)
    r = profiling.report()
    assert r["spans"] == [] and r["counters"] == {} and r["device"] == [] and r["calls"] == []
    with profiling.tracing():
        assert profiling.enabled() and profiling.span("a") is not first
        with profiling.tracing():
            assert profiling.enabled()
        assert profiling.enabled()
    assert not profiling.enabled()


def test_spans_are_record_function_events_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        with profiling.span("grafx.test.outer"):
            with profiling.span("grafx.test.inner"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "grafx.test.outer" in names and "grafx.test.inner" in names


def test_render_records_one_stage_span_per_stage():
    procs, plan, params = small_render()
    x = torch.randn(2, 3, 2, 256)
    with profiling.tracing():
        out = render_grafx(procs, x, params, plan)[0]
    assert torch.equal(out, render_grafx(procs, x, params, plan)[0])
    spans = profiling.report()["spans"]
    stages = named(spans, "grafx.render.stage")
    want = [(i, plan.iter_list[i].node_type) for i in range(1, plan.max_order + 1)]
    assert [(s["attrs"]["index"], s["attrs"]["node_type"]) for s in stages] == want
    assert [s["attrs"]["nodes"] for s in stages] == [
        plan.iter_list[i].dest_write.num_rows for i in range(1, plan.max_order + 1)]
    for part in ("read", "process", "write"):
        children = named(spans, f"grafx.render.stage.{part}")
        assert [c["parent"] for c in children] == [s["id"] for s in stages]
    process = named(spans, "grafx.render.stage.process")
    assert [p["attrs"]["node_type"] for p in process] == [t for _, t in want]


def test_setup_spans_are_recorded_with_tracing_off():
    G = bench_graph(2)
    procs = bench_processors()
    G_fused, procs_fused = fuse_serial_lti(G, procs, kinds=("fir", "iir", "dynamics"),
                                           dynamics_pad="auto")
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G_fused), method="beam"))
    fuse_parameters(create_empty_parameters(procs, G), G, G_fused, procs_fused)
    r = profiling.report()
    assert r["spans"] == []
    names = [s["name"] for s in r["setup"]]
    for name in ("grafx.plan.fuse", "grafx.plan.order", "grafx.plan.prepare",
                 "grafx.plan.migrate"):
        assert name in names, names
    migrate = named(r["setup"], "grafx.plan.migrate")[-1]
    # the migration schedules both graphs: its order spans are its children
    assert [s["parent"] for s in r["setup"] if s["name"] == "grafx.plan.order"][-2:] \
        == [migrate["id"]] * 2
    with profiling.setup_span("grafx.test.once", n=2) as once:
        pass
    assert once.seconds >= 0 and profiling.report()["setup"][-1]["attrs"] == {"n": 2}
    assert plan.max_order > 0


def test_setup_spans_keep_the_newest():
    for i in range(profiling.SETUP_KEPT + 5):
        with profiling.setup_span("grafx.test.many", i=i):
            pass
    setup = profiling.report()["setup"]
    assert len(setup) == profiling.SETUP_KEPT
    assert setup[-1]["attrs"]["i"] == profiling.SETUP_KEPT + 4


def test_report_round_trips_through_json():
    procs, plan, params = small_render()
    f = make_render_fn(procs, plan)
    with profiling.tracing():
        profiling.count("grafx.test.counter", 2)
        f(torch.randn(3, 2, 256), params)
    r = profiling.report()
    assert json.loads(json.dumps(r)) == r
    assert r["counters"] == {"grafx.test.counter": 2}
    (call,) = r["calls"]
    # off the card a compiled function runs as it is: no launch, no device
    assert call["fn"] == "make_render_fn(jit=True)" and call["path"] == "eager"
    assert call["launch_ms"] is None and call["device"] is None and call["host_ms"] > 0
    assert {s["name"] for s in r["spans"] if s["parent"] == call["call"]} == {
        "grafx.call.key", "grafx.render.stage"}


def test_counters_count_only_while_tracing():
    profiling.count("grafx.test.c")
    with profiling.tracing():
        profiling.count("grafx.test.c")
        profiling.count("grafx.test.c", 4)
    profiling.count("grafx.test.c")
    assert profiling.report()["counters"] == {"grafx.test.c": 5}
    profiling.reset()
    assert profiling.report()["counters"] == {}


def test_marks_pair_into_intervals_and_calls_summarise():
    """The report's reduction on made-up spans and read marks: marks of
    one name in one call pair in time order; a call's summary takes its
    launch, its device interval and its stages' and processors' device
    time (ns in, ms out)."""
    ms = 1_000_000

    def point(name, t, call, **attrs):
        return {"name": name, "t": t * ms, "call": call, "attrs": attrs}

    points = [point("grafx.call.copy_in", 0, 1), point("grafx.call.copy_in", 0.2, 1),
              point("grafx.call.graph", 0.5, 1), point("grafx.call.graph", 9.5, 1),
              point("grafx.call.clone_out", 9.5, 1), point("grafx.call.clone_out", 10, 1)]
    for i, (a, b) in enumerate([(1, 4), (4, 9)]):
        t = "eq" if i == 0 else "gain"
        points += [point("grafx.render.stage", a, 1, index=i + 1, node_type=t),
                   point("grafx.render.stage.process", a + 0.5, 1, node_type=t),
                   point("grafx.render.stage.process", b - 1, 1),
                   point("grafx.render.stage", b, 1)]
    points.append(point("grafx.lonely", 3, 1))
    intervals, single = profiling._intervals(points[::-1])
    assert [i["name"] for i in intervals].count("grafx.render.stage") == 2
    assert single == [point("grafx.lonely", 3, 1)]
    spans = [
        {"name": "grafx.call", "start": 0, "end": 12 * ms, "id": 1, "parent": None, "call": 1,
         "attrs": {"fn": "f", "path": "replay"}},
        {"name": "grafx.call.trace", "start": 1 * ms, "end": 2 * ms, "id": 2, "parent": 1,
         "call": 1, "attrs": {}},
        {"name": "grafx.call.launch", "start": 3 * ms, "end": 5 * ms, "id": 3, "parent": 1,
         "call": 1, "attrs": {}},
    ]
    # the call's marks took 0.5 ms of the host's time, the tracer's as its spans are
    (s,) = profiling._summaries(spans, intervals, {1: ms // 2})
    assert s["host_ms"] == 12 and s["launch_ms"] == 2 and s["tracing_ms"] == 1.5
    assert s["entry_ms"] == 8.5 and s["device"] == [0, 10 * ms] and s["device_ms"] == 10
    assert s["host_parts_ms"] == {"grafx.call.trace": 1, "grafx.call.launch": 2}
    # the launch's wait between the copy-in and the graph's first node is no part
    assert s["busy"] == [[0, 0.2 * ms], [0.5 * ms, 10 * ms]]
    assert s["launch_wait_ms"] == pytest.approx(0.3)
    assert s["stage_ms"] == 8 and s["process_ms"] == pytest.approx(5.0)
    assert s["executor_ms"] == pytest.approx(3.0)
    assert s["process_ms_by_type"] == pytest.approx({"eq": 1.5, "gain": 3.5})
    assert s["backward_ms"] is None and s["precompute_ms"] == 0
    assert s["fn"] == "f" and s["path"] == "replay"


def test_launch_counts_are_what_they_were():
    names = {w.__name__ for w in ballistics.KERNEL_WRAPPERS}
    assert len(names) == 16 and set(ballistics.launch_counts()) == names
    ballistics.reset_launch_counts()
    assert set(ballistics.launch_counts().values()) == {0}
    u = torch.rand(2, 64)
    consts = [torch.full((2,), v) for v in (0.0, 0.9, 0.8)]
    with profiling.tracing():
        ballistics.ballistics_core(u, *consts)  # the plain version on the CPU
    assert set(ballistics.launch_counts().values()) == {0}
    assert profiling.report()["counters"] == {}


@pytest.mark.parametrize("traced_capture", [True, False])
def test_counts_in_a_capture_are_the_graphs(traced_capture):
    """A count made inside a capture (a kernel wrapper's launch) goes to
    the capture's record, tracing on or off, and counts again at each
    traced replay; outside one it counts at once."""

    def capture():
        with profiling.capture_marks() as record:
            profiling.count("ballistics.walk", 2)
        return record

    if traced_capture:
        with profiling.tracing():
            record = capture()
    else:
        record = capture()
    assert record.counts == {"ballistics.walk": 2} and record.marks == []
    assert profiling.report()["counters"] == {}
    profiling.replay_launched(record)  # tracing off: nothing
    with profiling.tracing():
        profiling.count("ballistics.walk")
        profiling.replay_launched(record)
        profiling.replay_launched(record)
    assert profiling.report()["counters"] == {"ballistics.walk": 5}


def factorized_processors(frame_len):
    return {**bench_processors(), "compressor": FactorizedCompressor(frame_len=frame_len)}


def frame_counts(c, batch, length, frame_len):
    """``(frames, composed runs)`` a call of the factorized console ``c``
    should count: every compressor node's rows walk ``ceil(length /
    frame_len)`` frames (a track's in its fused gate -> compressor run, a
    bus's alone), and each stage of a fused dynamics chain composes."""
    nodes = sum(c.graph.nodes[n]["node_type"] == "compressor" for n in c.graph.nodes)
    composed = sum(isinstance(c.fused_processors.get(s.node_type), FusedDynamicsChain)
                   for s in c.plan.iter_list[1:])
    return nodes * batch * -(-length // frame_len), composed


@pytest.mark.parametrize("path", ["render", "step"])
def test_frame_smoothers_and_composed_runs_are_counted(path):
    """A traced call of the factorized console counts the frames its
    frame smoothers walk (rows x frames), all of them by the frame gain
    op, and the dynamics runs that compose their members' gains, and
    spans each frame smoother; with tracing off no counter appears."""
    batch, length, frame_len = 2, 1000, 256  # a ragged last frame
    c = bench_console(3, device="cpu", processors=factorized_processors(frame_len))
    frames, composed = frame_counts(c, batch, length, frame_len)
    assert composed == 1 and frames == 5 * batch * 4
    x = torch.randn(batch, 3, 2, length, generator=torch.Generator().manual_seed(5))
    if path == "render":
        render = make_render_fn(c.fused_processors, c.plan)

        def call():
            with torch.inference_mode():
                render(x, c.params)
    else:
        trainer = bench_trainer(3, device="cpu", processors=factorized_processors(frame_len))
        y = torch.randn(batch, 1, 2, length, generator=torch.Generator().manual_seed(6))

        def call():
            trainer.step(x, y)

    call()
    assert profiling.report()["counters"] == {}
    with profiling.tracing():
        call()
        call()
    r = profiling.report()
    assert r["counters"]["ballistics.frame.frames"] == 2 * frames
    assert r["counters"]["ballistics.frame.fused"] == 2 * frames
    assert r["counters"]["grafx.dynamics.composed"] == 2 * composed
    # the track rows' frame smoother and the buses'
    assert len(named(r["spans"], "grafx.dynamics.frame")) == 2 * 2


# -- on the card ---------------------------------------------------------


def card_console(device, length=2**14):
    c = bench_console(3, device=device)
    render = make_render_fn(c.fused_processors, c.plan)
    x = torch.randn(2, 3, 2, length, device=device)
    return c, render, x


def traced_calls(render, x, params, calls):
    """``calls`` traced calls, each waited for, as a server's are."""
    with torch.inference_mode(), profiling.tracing():
        for _ in range(calls):
            render(x, params)
            torch.cuda.synchronize()
    return profiling.report()


@pytest.mark.card
def test_marks_in_a_graph_record_again_on_every_replay(card):
    c, render, x = card_console(card)
    r = traced_calls(render, x, c.params, 5)
    assert [k["path"] for k in r["calls"]] == ["eager", "capture", "capture", "replay", "replay"]
    stages = c.plan.max_order
    replays = r["calls"][1:]
    for k in replays:
        mine = [i for i in r["device"] if i["call"] == k["call"]]
        assert sum(i["name"] == "grafx.render.stage" for i in mine) == stages
        assert sum(i["name"] == "grafx.render.stage.process" for i in mine) == stages
        assert k["device_ms"] > 0 and k["launch_ms"] > 0 and k["entry_ms"] > 0
        assert k["launch_wait_ms"] >= 0 and len(k["busy"]) in (1, 2, 3)
    starts = [k["device"][0] for k in replays]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)
    counters = r["counters"]
    assert counters["grafx.call.replays"] == 4 and counters["grafx.call.captures"] == 2
    assert counters["grafx.call.eager"] == 1
    assert counters.get("tracing.events_unread", 0) == 0
    # the capture's launches, counted at each replay, and the eager call's own
    assert counters["ballistics.ballistics_gain_pair_core"] == 5
    assert counters["ballistics.ballistics_gain_core"] == 5
    assert json.loads(json.dumps(r)) == r


@pytest.mark.card
def test_stage_intervals_lie_inside_their_call(card):
    c, render, x = card_console(card)
    r = traced_calls(render, x, c.params, 4)
    for k in r["calls"][1:]:
        lo, hi = k["device"]
        mine = [i for i in r["device"]
                if i["call"] == k["call"] and i["name"].startswith("grafx.render")]
        assert mine
        for i in mine:
            assert lo <= i["start"] <= i["end"] <= hi, (i, k["device"])
        stages = [i for i in mine if i["name"] == "grafx.render.stage"]
        for p in (i for i in mine if i["name"] == "grafx.render.stage.process"):
            assert any(s["start"] <= p["start"] <= p["end"] <= s["end"] for s in stages)
        assert 0 < k["process_ms"] <= k["stage_ms"] <= k["device_ms"]


@pytest.mark.card
def test_a_traced_step_times_its_backward(card):
    trainer = bench_trainer(3, device=card)
    x = torch.randn(1, 3, 2, 2**14, device=card)
    y = torch.randn(1, 1, 2, 2**14, device=card)
    with profiling.tracing():
        for _ in range(4):
            trainer.step(x, y)
            torch.cuda.synchronize()
    r = profiling.report()
    k = r["calls"][-1]
    assert k["path"] == "replay" and k["backward_ms"] > 0 and k["stage_ms"] > 0
    assert k["backward_ms"] + k["stage_ms"] + k["precompute_ms"] <= k["device_ms"]
    assert r["counters"].get("ballistics.ballistics_gain_pair_bwd", 0) == 4


@pytest.mark.card
def test_a_traced_factorized_step_times_its_frame_smoothers(card):
    """On the card a replayed factorized step records the frame
    smoothers' device intervals and the counters (the capture's counts
    again at each replay): every frame walked by the frame gain op, whose
    forward and adjoint launch twice a step."""
    batch, length, frame_len = 1, 2**14, 1024
    trainer = bench_trainer(3, device=card, processors=factorized_processors(frame_len))
    c = bench_console(3, device="cpu", processors=factorized_processors(frame_len))
    frames, composed = frame_counts(c, batch, length, frame_len)
    x = torch.randn(batch, 3, 2, length, device=card)
    y = torch.randn(batch, 1, 2, length, device=card)
    with profiling.tracing():
        for _ in range(4):
            trainer.step(x, y)
            torch.cuda.synchronize()
    r = profiling.report()
    k = r["calls"][-1]
    assert k["path"] == "replay"
    mine = [i for i in r["device"] if i["call"] == k["call"] and i["name"] == "grafx.dynamics.frame"]
    assert len(mine) == 2 and all(i["end"] > i["start"] for i in mine)
    assert r["counters"]["ballistics.frame.frames"] == 4 * frames
    assert r["counters"]["ballistics.frame.fused"] == r["counters"]["ballistics.frame.frames"]
    assert r["counters"]["ballistics.frame_gain_fwd"] == 4 * 2
    assert r["counters"]["ballistics.frame_gain_bwd"] == 4 * 2
    assert r["counters"]["grafx.dynamics.composed"] == 4 * composed


def replay_kernels(fn):
    """Device operations of one call of ``fn`` under the profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("grafx.")]


@pytest.mark.card
def test_traced_and_untraced_signatures_are_two_graphs(card):
    c, render, x = card_console(card)
    fresh = make_render_fn(c.fused_processors, c.plan)
    with torch.inference_mode():
        for _ in range(2):
            render(x, c.params)
            fresh(x, c.params)
        traced_calls(render, x, c.params, 3)
        # two signatures: the untraced one's graph, the traced one's two
        assert isinstance(render, CapturedFunction)
        assert sorted(len(g) for g in render._graphs.values()) == [1, 2]
        assert [len(g) for g in fresh._graphs.values()] == [1]
        untraced = replay_kernels(lambda: render(x, c.params))
        never = replay_kernels(lambda: fresh(x, c.params))
        with profiling.tracing():
            traced = replay_kernels(lambda: render(x, c.params))
    assert sorted(untraced) == sorted(never)
    assert sorted(traced) == sorted(untraced)  # the marks are event nodes, not kernels


ANCHOR_US = 25.0  # the stated bound of the anchor's error on the card


@pytest.mark.card
def test_the_anchor_agrees_with_the_profiler(card):
    """The ends of the traced replays' processor and graph intervals
    (marks queued right behind a processor's last kernel, or a graph's)
    against the nearest end of a device operation in the
    profiler's trace, both on the host clock: the profiler's clock is put
    on it by the ``record_function`` mirrors of the launch spans.  The
    profiler's own placement of device events scatters by some us from
    call to call, so the median is held to the bound."""
    c, render, x = card_console(card)
    with torch.inference_mode():
        traced_calls(render, x, c.params, 3)
        profiling.reset()
        with profiling.tracing(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                render(x, c.params)
                torch.cuda.synchronize()
    r = profiling.report()
    events = list(prof.events())
    mirrors = sorted(e.time_range.start for e in events
                     if e.device_type != torch.autograd.DeviceType.CUDA
                     and e.name == "grafx.call.launch")
    ours = [s["start"] / 1e3 for s in r["spans"] if s["name"] == "grafx.call.launch"]
    assert len(ours) == len(mirrors) == 8
    offset = statistics.median(a - b for a, b in zip(ours, mirrors))
    ends = [e.time_range.end + offset for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("grafx.")]
    marks = [i["end"] / 1e3 for i in r["device"]
             if i["name"] in ("grafx.render.stage.process", "grafx.call.graph")
             and i["end"] - i["start"] > 20_000]
    assert len(marks) > 8 * 5
    # each mark's time less the nearest device operation's end
    errors = sorted(min((m - e for e in ends), key=abs) for m in marks)
    q = statistics.quantiles(errors, n=4)
    print(f"anchor error us: median {statistics.median(errors):.2f}, quartiles {q[0]:.2f}"
          f" {q[2]:.2f}, least {errors[0]:.2f}, most {errors[-1]:.2f} over {len(errors)}"
          f" marks; the anchor's own bound {r['anchors']['0']['error_bound_us']} us")
    assert abs(statistics.median(errors)) <= ANCHOR_US
