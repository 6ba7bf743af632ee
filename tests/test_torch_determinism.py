"""The port's fan-in without atomics (``render/core.py``:
``StaticSegmentSum``, ``StaticGather``; ``ops/stft.py``'s reflect
padding) against grafx_tpu on the same numpy inputs, and a dispatch
audit of the warm paths for ops that add by atomics on the card.

``aggregate_tensor`` is held against ``grafx_tpu.render.core.
aggregate_tensor`` (static slice sums where sorted, ``.at[].add``
otherwise) within 1e-6 x max|ref|: float32 sums of at most 20 rows may
add in another order.  Its VJP is a gather in both packages and comes out
bit for bit equal, and so does the forward wherever no segment has more
than two rows.  A read that repeats a row is held the same way against
``jnp.take``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from grafx_tpu import processors as jp
from grafx_tpu.processors.core.delay import SurrogateDelay as JSurrogateDelay
from grafx_tpu.processors.nonlinear import ChebyshevDistortion as JChebyshevDistortion
from grafx_tpu.render import render_grafx as j_render
from grafx_tpu.render.core import aggregate_tensor as j_aggregate
from grafx_tpu.render.core import read_tensor as j_read
from grafx_tpu.render.prepare import Aggregation as JAggregation
from grafx_tpu.render.prepare import TensorAccess as JTensorAccess
from grafx_tpu_torch.models import GraphParameterOptimizer, bench_console, bench_trainer, mixing_console
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops.losses import mse_loss
from grafx_tpu_torch.processors import ChebyshevDistortion, FactorizedCompressor, StereoGain
from grafx_tpu_torch.processors.core.delay import SurrogateDelay
from grafx_tpu_torch.render import StreamRenderer, make_render_fn, render_grafx
from grafx_tpu_torch.render.core import StaticGather, StaticSegmentSum, aggregate_tensor, read_tensor
from grafx_tpu_torch.render.prepare import TensorAccess, check_aggregate_method, plan_segment_sum
from grafx_tpu_torch.utils import parameters_from_numpy
from test_torch_buffer import PORT, REF, jax_tree, numpy_params, plans
from test_torch_train import console_input

# the package's ops/__init__ re-exports a function named stft over the module
stft = importlib.import_module("grafx_tpu_torch.ops.stft")
REL = 1e-6  # max abs <= REL x max|ref|: float32 sums of <= 20 rows in another order

# (each row's segment, number of segments)
SCATTERS = {
    "sorted_ragged": ((0, 0, 0, 1, 1, 2, 2, 2, 2), 3),
    "equal_runs": ((0, 0, 0, 1, 1, 1, 2, 2, 2), 3),
    "console_mix": ((0,) * 8 + (1,) * 9, 2),
    "twenty_rows": ((0,) * 20 + (1,), 2),
    "unsorted": ((2, 0, 1, 0, 2, 1, 1), 3),
    "empty_sorted": ((0, 0, 2, 2, 4), 5),
    "empty_unsorted": ((3, 0, 3, 0, 3), 5),
    "pairs": ((1, 0, 1, 0), 2),
}
# (input shape with N rows along dim, dim)
LAYOUTS = {"3d_dim0": ((None, 2, 64), 0), "3d_dim1": ((3, None, 64), 1),
           "4d_dim0": ((None, 2, 2, 32), 0), "4d_dim1": ((2, None, 2, 32), 1)}


def layout(name, n):
    shape, dim = LAYOUTS[name]
    return tuple(n if s is None else s for s in shape), dim


def relative(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("layout_name", list(LAYOUTS))
@pytest.mark.parametrize("case", list(SCATTERS))
def test_aggregate_matches_grafx_tpu(case, layout_name):
    idx, num_segments = SCATTERS[case]
    shape, dim = layout(layout_name, len(idx))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    out_shape = list(shape)
    out_shape[dim] = num_segments
    cot = rng.standard_normal(out_shape).astype(np.float32)

    agg = check_aggregate_method(idx, list(range(num_segments)))
    assert agg.method == "scatter"
    ref, vjp = jax.vjp(lambda a: j_aggregate(a, JAggregation("scatter", idx, num_segments), dim),
                       jnp.asarray(x))
    ref, ref_grad = np.asarray(ref), np.asarray(vjp(jnp.asarray(cot))[0])

    xt = torch.tensor(x, requires_grad=True)
    y = aggregate_tensor(xt, agg, dim=dim)
    (grad,) = torch.autograd.grad(y, xt, torch.tensor(cot))
    assert y.shape == ref.shape
    assert relative(y.detach().numpy(), ref) <= REL
    if agg.segments.width <= 2:  # a + b is the same either way round
        np.testing.assert_array_equal(y.detach().numpy(), ref)
    np.testing.assert_array_equal(grad.numpy(), ref_grad)  # both gather
    with torch.no_grad():  # the plain path is the Function's forward
        assert torch.equal(aggregate_tensor(xt, agg, dim=dim), y)


def test_segment_plans():
    """Equal sorted runs take the one-reduction path; the rest place each
    row in a zero grid, one row of ``width`` slots a filled segment, in
    the order of ``idx``."""
    equal = plan_segment_sum(*SCATTERS["equal_runs"])
    assert equal.run == 3
    ragged = plan_segment_sum(*SCATTERS["empty_unsorted"])  # (3, 0, 3, 0, 3) into 5
    assert ragged.run == 0 and ragged.width == 3 and ragged.filled == (0, 3)
    assert ragged.slots == (3, 0, 4, 1, 5)
    assert plan_segment_sum(*SCATTERS["unsorted"]).slots == (6, 0, 3, 1, 7, 4, 5)
    assert plan_segment_sum(*SCATTERS["console_mix"]).slots == tuple(range(8)) + tuple(range(9, 18))
    with pytest.raises(ValueError, match="outside"):
        plan_segment_sum((0, 2), 2)


@pytest.mark.parametrize("layout_name", list(LAYOUTS))
@pytest.mark.parametrize("idx", [(2, 2, 2, 2, 0), (1, 4, 1, 3, 1, 4)], ids=["four_way", "mixed"])
def test_repeated_read_matches_grafx_tpu(idx, layout_name):
    """An index read that repeats a row: ``StaticGather``, whose backward
    sums each source row's reads, against ``jnp.take`` and its VJP."""
    shape, dim = layout(layout_name, 5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    out_shape = list(shape)
    out_shape[dim] = len(idx)
    cot = rng.standard_normal(out_shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: j_read(a, JTensorAccess("index", idx), dim), jnp.asarray(x))
    ref_grad = np.asarray(vjp(jnp.asarray(cot))[0])

    xt = torch.tensor(x, requires_grad=True)
    y = read_tensor(xt, TensorAccess("index", idx), dim=dim)
    assert y.grad_fn.name().startswith("StaticGather")
    (grad,) = torch.autograd.grad(y, xt, torch.tensor(cot))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref))
    assert relative(grad.numpy(), ref_grad) <= REL


def test_unique_read_stays_a_plain_gather():
    xt = torch.randn(5, 2, 8, requires_grad=True)
    y = read_tensor(xt, TensorAccess("index", (4, 0, 2)))
    assert y.grad_fn.name().startswith("IndexSelect")


@pytest.mark.parametrize("case", ["sorted_ragged", "equal_runs", "unsorted", "empty_unsorted"])
@pytest.mark.parametrize("dim", [0, 1])
def test_gradcheck_static_functions(case, dim):
    """Both Functions in float64, first and second order (each is the
    other's adjoint)."""
    idx, num_segments = SCATTERS[case]
    plan = plan_segment_sum(idx, num_segments)
    shape = [3, 3, 5]
    shape[dim] = len(idx)
    x = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: StaticSegmentSum.apply(a, plan, dim), (x,))
    assert torch.autograd.gradgradcheck(lambda a: StaticSegmentSum.apply(a, plan, dim), (x,))
    shape[dim] = num_segments
    src = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: StaticGather.apply(a, plan, dim), (src,))
    assert torch.autograd.gradgradcheck(lambda a: StaticGather.apply(a, plan, dim), (src,))


# ---------------------------------------------------------------------------
# dispatch audit: no op that adds two values into one place by atomics on
# the card, nor reflection padding's backward (which does, and which
# torch.use_deterministic_algorithms refuses)


def _repeats(index, dim=0):
    """Whether an integer index repeats a value along ``dim``."""
    if index.numel() == 0:
        return False
    return bool((index.sort(dim=dim).values.diff(dim=dim) == 0).any())


def _repeated_keys(indices):
    """Whether advanced indices (a list, ``None`` for a full dim) name one
    element twice; boolean masks name each element once."""
    indices = [i for i in indices if i is not None]
    if not indices or any(i.dtype == torch.bool for i in indices):
        return False
    keys = torch.stack(torch.broadcast_tensors(*indices)).flatten(1).T
    return keys.unique(dim=0).shape[0] < keys.shape[0]


class AccumulatingOps(TorchDispatchMode):
    """Records every op that adds several values into one element by
    atomics on CUDA: ``index_add`` and accumulating ``index_put`` with a
    repeated index, ``scatter_add`` with a repeated index along its dim,
    and reflection padding's backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_add", "index_add_"):
            if _repeats(args[2]):
                self.seen.append(name)
        elif name in ("index_put", "index_put_", "_index_put_impl_"):
            accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            if accumulate and _repeated_keys(args[1]):
                self.seen.append(name)
        elif name in ("scatter_add", "scatter_add_"):
            if _repeats(args[2], args[1]):
                self.seen.append(name)
        elif name.startswith("reflection_pad") and name.endswith("backward"):
            self.seen.append(name)
        return func(*args, **kwargs)


def test_audit_sees_atomic_fan_in():
    """The audit itself: ``index_select``'s backward with a repeated
    index, a repeated ``scatter_add`` and reflection padding's backward
    are each recorded; a unique index is not."""
    x = torch.randn(4, 3, 16, requires_grad=True)
    with AccumulatingOps() as ops:
        x.index_select(0, torch.tensor([1, 2, 0])).sum().backward()
        assert ops.seen == []
        x.index_select(0, torch.tensor([1, 1, 0])).sum().backward()
        torch.zeros(3).scatter_add(0, torch.tensor([0, 0]), torch.ones(2))
        F.pad(x, (2, 2), mode="reflect").sum().backward()
    assert ops.seen == ["index_add", "scatter_add", "reflection_pad1d_backward"]


FAN_OUT = 4


def fan_out_graph(mod):
    """One gain feeding four gains of one stage, summed into the output:
    under ``buffer_mode="array"`` that stage reads one buffer row four
    times."""
    G = mod[0](config=mod[1](["gain"]))
    _, first = G.add_serial_chain(["in", "gain"])
    mix = G.add("mix")
    for _ in range(FAN_OUT):
        g = G.add("gain")
        G.connect(first, g)
        G.connect(g, mix)
    G.connect(mix, G.add("out"))
    return G


CHAINS, BATCH, LENGTH, BLOCK = 3, 2, 2**12, 1024


def _audit_paths():
    """Each path of the audit as a thunk, on the CPU at 3 chains."""
    rng = np.random.default_rng(5)
    x = torch.tensor(console_input(rng, (BATCH, CHAINS, 2, LENGTH)))
    target = torch.tensor(rng.standard_normal((BATCH, 1, 2, LENGTH)).astype(np.float32))
    c = bench_console(CHAINS, device="cpu")
    render = make_render_fn(c.fused_processors, c.plan)
    streamer = StreamRenderer(c.fused_processors, c.plan, c.params, block_len=BLOCK)
    state = streamer.init_state()
    exact = bench_trainer(CHAINS, device="cpu")
    factorized = bench_trainer(CHAINS, device="cpu", processors={
        **bench_processors(), "compressor": FactorizedCompressor(frame_len=256)})
    G, procs = mixing_console(num_tracks=CHAINS, ir_len=2000)
    fit = GraphParameterOptimizer(G, procs, device="cpu")  # MR-STFT loss, Adam

    G_fan = [fan_out_graph(m) for m in (PORT, REF)]
    plan, _ = plans(G_fan, "beam")
    assert any(r.method == "index" and len(set(r.idx)) < len(r.idx)
               for s in plan.iter_list for r in s.source_reads)
    fan_params = parameters_from_numpy(numpy_params({"gain": StereoGain()}, G_fan[0], 3))
    x_fan = torch.tensor(rng.standard_normal((BATCH, 1, 2, 256)).astype(np.float32))

    def request():
        with torch.inference_mode():
            return render(x, c.params)

    def array_request():
        with torch.inference_mode():
            return render_grafx({"gain": StereoGain()}, x_fan, fan_params, plan, buffer_mode="array")

    def array_step():
        leaves = {t: {k: v.clone().requires_grad_(True) for k, v in d.items()} for t, d in fan_params.items()}
        xg = x_fan.clone().requires_grad_(True)
        y = render_grafx({"gain": StereoGain()}, xg, leaves, plan, buffer_mode="array")[0]
        mse_loss(y, torch.zeros_like(y)).backward()

    return {
        "exact request": request,
        "exact step": lambda: exact.step(x, target),
        "factorized step": lambda: factorized.step(x, target),
        "stream block": lambda: streamer(x[0, ..., :BLOCK], state),
        "MR-STFT fit step": lambda: fit.step(x[0], target[0]),
        "array request": array_request,
        "array step": array_step,
    }


@pytest.mark.parametrize("path", ["exact request", "exact step", "factorized step", "stream block",
                                  "MR-STFT fit step", "array request", "array step"])
def test_warm_path_adds_nothing_by_atomics(path):
    run = _audit_paths()[path]
    run()
    with AccumulatingOps() as ops:
        run()
    assert ops.seen == []


def test_array_fan_out_matches_jax_grad():
    """The four-way fan-out through the array buffer: render and every
    gradient against ``jax.grad`` of grafx_tpu's render in the same mode."""
    G = [fan_out_graph(m) for m in (PORT, REF)]
    plan, jplan = plans(G, "beam")
    params = numpy_params({"gain": StereoGain()}, G[0], 4)
    x = np.random.default_rng(2).standard_normal((2, 1, 2, 2**9)).astype(np.float32)
    pt = parameters_from_numpy(params)
    xt = torch.tensor(x, requires_grad=True)
    pt["gain"]["log_gain"].requires_grad_(True)
    y = render_grafx({"gain": StereoGain()}, xt, pt, plan, buffer_mode="array")[0]
    y.pow(2).mean().backward()
    jprocs = {"gain": jp.StereoGain()}
    ref = j_render(jprocs, jnp.asarray(x), jax_tree(params), jplan, buffer_mode="array")[0]
    gp, gx = jax.grad(
        lambda p, a: jnp.mean(j_render(jprocs, a, p, jplan, buffer_mode="array")[0] ** 2),
        argnums=(0, 1))(jax_tree(params), jnp.asarray(x))
    assert relative(y.detach().numpy(), np.asarray(ref)) <= REL
    assert relative(pt["gain"]["log_gain"].grad.numpy(), np.asarray(gp["gain"]["log_gain"])) <= REL
    assert relative(xt.grad.numpy(), np.asarray(gx)) <= REL


# ---------------------------------------------------------------------------
# the STFT's reflect padding


@pytest.mark.parametrize("pad, length", [(1, 2), (96, 97), (256, 1000), (1024, 4109)])
def test_reflect_pad_equals_torch_reflect(pad, length):
    x = torch.randn(3, length)
    assert torch.equal(stft._reflect_pad(x, pad), F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0])
    xg = x.clone().requires_grad_(True)
    cot = torch.randn(3, length + 2 * pad)
    (got,) = torch.autograd.grad(stft._reflect_pad(xg, pad), xg, cot)
    (ref,) = torch.autograd.grad(F.pad(xg[:, None], (pad, pad), mode="reflect")[:, 0], xg, cot)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_reflect_pad_refuses_a_pad_past_the_signal():
    """A pad as long as the signal or longer reflects again (as jnp.pad
    does; test_reflect_pad_past_the_signal_equals_jnp_pad); only an empty
    signal, which has nothing to reflect, is refused (as jnp.pad refuses
    it)."""
    with pytest.raises(ValueError, match="reflect padding"):
        stft._reflect_pad(torch.randn(2, 0), 8)
    with pytest.raises(ValueError):
        jnp.pad(jnp.zeros((2, 0)), ((0, 0), (8, 8)), mode="reflect")


@pytest.mark.parametrize("pad, length", [(1, 1), (3, 2), (8, 8), (25, 5), (1023, 700), (1024, 1024)])
def test_reflect_pad_past_the_signal_equals_jnp_pad(pad, length):
    """Pads as long as the signal or longer (an STFT of n_fft // 2 samples
    or fewer) equal jnp.pad's reflect mode value for value, and their
    VJP equals jax.vjp's."""
    x = np.random.default_rng(length).standard_normal((3, length)).astype(np.float32)
    cot = np.random.default_rng(pad).standard_normal((3, length + 2 * pad)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jnp.pad(v, ((0, 0), (pad, pad)), mode="reflect"), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = stft._reflect_pad(xt, pad)
    assert np.array_equal(got.detach().numpy(), np.asarray(ref))
    (gx,) = torch.autograd.grad(got, xt, torch.tensor(cot))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's two public statics


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 33)])
def test_get_hard_irs_matches_grafx_tpu(shape):
    irs = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    irs[0, ..., :3] = irs.max() + 1.0  # a tie: the first maximum wins in both
    got = SurrogateDelay.get_hard_irs(torch.tensor(irs, requires_grad=True))
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(JSurrogateDelay.get_hard_irs(jnp.asarray(irs))))


@pytest.mark.parametrize("use_tanh", [False, True])
def test_apply_distortion_matches_grafx_tpu(use_tanh):
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.2, 1.2, (3, 2, 512)).astype(np.float32)
    w = rng.standard_normal((3, 10)).astype(np.float32)
    ref = np.asarray(JChebyshevDistortion.apply_distortion(jnp.asarray(x), jnp.asarray(w), use_tanh))
    got = ChebyshevDistortion.apply_distortion(torch.tensor(x), torch.tensor(w), use_tanh=use_tanh)
    assert relative(got.numpy(), ref) <= REL
    dist = ChebyshevDistortion(pre_gain=False, use_tanh=use_tanh)
    assert torch.equal(dist(torch.tensor(x), torch.tensor(w)),
                       ChebyshevDistortion.apply_distortion(torch.tensor(x), torch.tanh(torch.tensor(w)),
                                                            use_tanh))
