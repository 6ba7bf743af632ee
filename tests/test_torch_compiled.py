"""The compiled form of the port's paths (``jit=True``; CUDA-graph capture
on the card, ``render/compiled.py``), checked on the CPU: no warm path
makes a tensor from host data or reads a device value on the host (the
two things a stream capture refuses); ``jit=True`` and ``jit=False`` agree
bit for bit here, where both run eagerly; a compiled render refuses
autograd; the captured step's plumbing refuses an optimizer it cannot
capture; the replay's fresh copies alias nothing."""

import contextlib
import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from grafx_tpu_torch.models import GraphParameterOptimizer, bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_graph, bench_processors
from grafx_tpu_torch.processors import FactorizedCompressor
from grafx_tpu_torch.render import StreamRenderer, check_capturable, make_render_fn
from grafx_tpu_torch.render.compiled import _Graph
from grafx_tpu_torch.render.core import _index_tensor
from grafx_tpu_torch.utils import tree_items
from test_torch_train import console_input

CHAINS, BATCH, L, BLOCK = 4, 2, 2**12, 1024
REFUSED_BY_CAPTURE = (torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default,
                      torch.ops.aten._local_scalar_dense.default)


class HostOps(TorchDispatchMode):
    """Records every op that makes a tensor from host data
    (``lift_fresh``) or reads a device value on the host
    (``_local_scalar_dense``: ``.item()``, ``float()``)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in REFUSED_BY_CAPTURE:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def factorized_processors():
    return {**bench_processors(), "compressor": FactorizedCompressor(frame_len=256)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    x = torch.tensor(console_input(rng, (BATCH, CHAINS, 2, L)))
    target = torch.tensor(rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32))
    return x, target


def _paths(inputs):
    """Each warm path as a thunk; the first call warms it."""
    x, target = inputs
    c = bench_console(CHAINS, device="cpu")
    render = make_render_fn(c.fused_processors, c.plan)
    streamer = StreamRenderer(c.fused_processors, c.plan, c.params, block_len=BLOCK)
    state = streamer.init_state()
    exact = bench_trainer(CHAINS, device="cpu")
    factorized = bench_trainer(CHAINS, device="cpu", processors=factorized_processors())
    # the default MR-STFT loss; the default Adam reads its step count on
    # the host on the CPU, where torch refuses its capturable form
    stft = GraphParameterOptimizer(bench_graph(CHAINS), bench_processors(), fuse="pad-auto",
                                   optimizer=lambda p: torch.optim.SGD(p, lr=1e-3), device="cpu")

    def request():
        with torch.inference_mode():
            return render(x, c.params)

    return {
        "request": request,
        "exact step": lambda: exact.step(x, target),
        "factorized step": lambda: factorized.step(x, target),
        "MR-STFT step": lambda: stft.step(x, target),
        "stream block": lambda: streamer(x[0, ..., :BLOCK], state),
        "step_many": lambda: streamer.step_many(torch.stack(x[0].split(BLOCK, dim=-1)), state),
    }


@pytest.mark.parametrize("path", ["request", "exact step", "factorized step", "MR-STFT step",
                                  "stream block", "step_many"])
def test_warm_path_makes_no_host_tensor(inputs, path):
    run = _paths(inputs)[path]
    run()
    with HostOps() as ops:
        run()
    assert ops.seen == []


def _leaves(trainer):
    return {k: p.detach().clone() for k, p in tree_items(trainer.params)}


@pytest.mark.parametrize("make_processors", [bench_processors, factorized_processors],
                         ids=["exact", "factorized"])
def test_jit_step_equals_eager_step(inputs, make_processors):
    """Three steps with ``jit=True`` and with ``jit=False`` from the same
    start: the same losses and leaves, bit for bit."""
    x, target = inputs
    trainers = [bench_trainer(CHAINS, device="cpu", processors=make_processors(), jit=jit)
                for jit in (True, False)]
    for _ in range(3):
        (t1, a1), (t2, a2) = (tr.step(x, target) for tr in trainers)
        assert torch.equal(t1, t2) and torch.equal(a1, a2)
    got, ref = (_leaves(tr) for tr in trainers)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_jit_render_and_stream_equal_eager(inputs):
    x, _ = inputs
    c = bench_console(CHAINS, device="cpu")
    renders = [make_render_fn(c.fused_processors, c.plan, jit=jit) for jit in (True, False)]
    with torch.inference_mode():
        (y1, _, _), (y2, _, _) = (r(x, c.params) for r in renders)
        (_, _, b1), (_, _, b2) = (r(x, c.params, return_buffer=True) for r in renders)
    assert torch.equal(y1, y2) and torch.equal(b1, b2)
    streamers = [StreamRenderer(c.fused_processors, c.plan, c.params, block_len=BLOCK, jit=jit)
                 for jit in (True, False)]
    states = [s.init_state() for s in streamers]
    for xb in x[0].split(BLOCK, dim=-1):
        (ya, states[0]), (yb, states[1]) = (s(xb, st) for s, st in zip(streamers, states))
        assert torch.equal(ya, yb)
    many = [s.step_many(torch.stack(x[1].split(BLOCK, dim=-1)), s.init_state())[0] for s in streamers]
    assert torch.equal(many[0], many[1])


def test_jit_render_refuses_autograd():
    c = bench_console(2, device="cpu")
    x = torch.zeros(1, 2, 2, 256)
    params = {t: {k: v.clone().requires_grad_(True) if not isinstance(v, dict) else v
                  for k, v in sub.items()} for t, sub in c.params.items()}
    render = make_render_fn(c.fused_processors, c.plan)
    with pytest.raises(ValueError, match="jit=False"):
        render(x, params)
    with torch.no_grad():
        render(x, params)  # no autograd wanted: renders
    make_render_fn(c.fused_processors, c.plan, jit=False)(x, params)[0].sum().backward()


@pytest.mark.parametrize(
    "make, capturable",
    [
        (lambda p: torch.optim.SGD(p, lr=1e-3), True),
        (lambda p: torch.optim.SGD(p, lr=1e-3, momentum=0.9), True),
        (lambda p: torch.optim.Adam(p, lr=1e-2, capturable=True), True),
        (lambda p: torch.optim.Adam(p, lr=1e-2), False),
        (lambda p: torch.optim.Adagrad(p), False),
        (lambda p: torch.optim.LBFGS(p), False),
    ],
)
def test_check_capturable(make, capturable):
    """The captured step's plumbing refuses, with a message, an optimizer
    whose ``step()`` keeps host state."""
    optimizer = make([torch.zeros(3, requires_grad=True)])
    if capturable:
        check_capturable(optimizer)
    else:
        with pytest.raises(ValueError, match="capturable"):
            check_capturable(optimizer)


def test_fresh_copies_alias_nothing():
    """A replay returns copies of the graph's static outputs in the output
    tree: equal values, shapes and dtypes, in memory of their own, fresh
    on every replay (the graph itself is stubbed: there is none on the
    CPU)."""
    outs = (torch.randn(3, 5), {"a": torch.randn(()), "b": 7},
            torch.randn(4, 2, dtype=torch.complex64), torch.randn(7, 2).t(), torch.arange(4))
    graph = _Graph.__new__(_Graph)
    graph.inputs, graph.graph = [], SimpleNamespace(replay=lambda: None)
    graph.out_leaves, graph.out_spec = pytree.tree_flatten(outs)
    first, second = graph.replay([]), graph.replay([])
    src = [x for x in graph.out_leaves if isinstance(x, torch.Tensor)]
    assert first[1]["b"] == 7
    for copies in (first, second):
        out = [x for x in pytree.tree_leaves(copies) if isinstance(x, torch.Tensor)]
        for a, b in zip(src, out, strict=True):
            assert torch.equal(a, b) and a.dtype == b.dtype and a.shape == b.shape
            assert b.data_ptr() != a.data_ptr()
    ptrs = [x.data_ptr() for c in (first, second) for x in pytree.tree_leaves(c)
            if isinstance(x, torch.Tensor)]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("fails", [False, True])
@pytest.mark.parametrize("collecting", [True, False])
def test_capture_pauses_the_collector(monkeypatch, fails, collecting):
    """The cyclic collector does not run while a capture runs (it could
    free another graph, which invalidates the capture) and is back as it
    was afterwards, also after a capture that fails (the CUDA graph is
    stubbed: there is none on the CPU)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", lambda _: contextlib.nullcontext())
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("operation failed due to a previous error during capture")
        return x + 1

    was = gc.isenabled()
    (gc.enable if collecting else gc.disable)()
    try:
        if fails:
            with pytest.raises(RuntimeError, match="CUDA-graph capture of f failed"):
                _Graph(fn, "f", [torch.ones(2)], pytree.tree_flatten(((torch.ones(2),), {}))[1])
        else:
            graph = _Graph(fn, "f", [torch.ones(2)], pytree.tree_flatten(((torch.ones(2),), {}))[1])
            assert torch.equal(graph.out_leaves[0], torch.full((2,), 2.0))
        assert seen == [False] and gc.isenabled() == collecting
    finally:
        (gc.enable if was else gc.disable)()


def test_index_tensors_made_once():
    a = _index_tensor((2, 0, 1), torch.device("cpu"))
    assert a is _index_tensor((2, 0, 1), torch.device("cpu"))
    assert torch.equal(a, torch.tensor([2, 0, 1]))
