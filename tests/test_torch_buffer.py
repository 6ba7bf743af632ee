"""The array signal buffer and the one-by-one executor of grafx_tpu_torch
(``render/core.py``, ``render/graph.py``) against grafx_tpu on the same
numpy inputs: ragged one-by-one renders, one-by-one against scheduled
renders, the buffer modes, random graphs under every schedule and mode,
gradients through both buffers against ``jax.grad``, and the one-by-one
optimizer step.  Mirrors ``tests/graph/test_render.py:105-171`` and
``:422-562``; the bounds are that file's (rtol 1e-5 / atol 1e-6 across
schedules, 1e-6 / 1e-7 across modes)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.models.optimize import GraphParameterOptimizer as JOptimizer
from grafx_tpu.ops import losses as jlosses
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import render_grafx as j_render
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import GraphParameterOptimizer
from grafx_tpu_torch.models.console import bench_graph, bench_processors
from grafx_tpu_torch.ops import losses
from grafx_tpu_torch.processors import StereoGain, TanhDistortion
from grafx_tpu_torch.render import (
    CapturedFunction,
    StreamRenderer,
    create_signal_buffer,
    make_render_fn,
    prepare_render,
    render_grafx,
    reorder_for_fast_render,
    write_tensor,
)
from grafx_tpu_torch.render.fuse import _scheduled_type_rows
from grafx_tpu_torch.render.prepare import TensorAccess
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map
from test_torch_graph import jax_processors
from test_torch_train import console_input

PORT, REF = (GRAFX, NodeConfigs), (JGRAFX, JNodeConfigs)


def plans(G, method):
    """The port's plan of a port graph ``G[0]`` and grafx_tpu's of ``G[1]``."""
    return (prepare_render(reorder_for_fast_render(convert_to_tensor(G[0]), method=method)),
            j_prepare(j_reorder(j_convert(G[1]), method=method)))


def gain_graph(mod, num_sources=3):
    G = mod[0](config=mod[1](["gain"]))
    ends = [G.add_serial_chain(["in", "gain"])[1] for _ in range(num_sources)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


def scatter_graph(mod):
    """Two mixes in one stage (a scatter fan-in), as in grafx_tpu's
    ``test_buffer_modes_agree``."""
    G = mod[0](config=mod[1](["gain"]))
    ends = [G.add_serial_chain(["in", "gain"])[1] for _ in range(4)]
    mix_a, mix_b = G.add("mix"), G.add("mix")
    for e, m in zip(ends, (mix_a, mix_b, mix_a, mix_b)):
        G.connect(e, m)
    ga, gb = G.add("gain"), G.add("gain")
    G.connect(mix_a, ga)
    G.connect(mix_b, gb)
    out_mix = G.add("mix")
    G.connect(ga, out_mix)
    G.connect(gb, out_mix)
    G.connect(out_mix, G.add("out"))
    return G


def random_console(mod, seed):
    """``test_random_graph_schedules_and_modes_agree``'s console-style DAG."""
    rng = np.random.default_rng(seed)
    G = mod[0](config=mod[1](["gain", "dist"]))
    ends = []
    num_chains = int(rng.integers(2, 5))
    for _ in range(num_chains):
        chain = ["in"] + [str(rng.choice(["gain", "dist"])) for _ in range(int(rng.integers(1, 4)))]
        ends.append(G.add_serial_chain(chain)[1])
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    first, last = G.add_serial_chain(["gain", "dist"])
    G.connect(mix, first)
    G.connect(last, G.add("out"))
    return G, num_chains


def numpy_params(processors, G, seed, std=0.3):
    """Per-type parameters from numpy, shaped by the port's processors."""
    rng = np.random.default_rng(seed)
    counts = {}
    for _, d in G.nodes(data=True):
        counts[d["node_type"]] = counts.get(d["node_type"], 0) + 1
    return {t: {k: (std * rng.standard_normal((counts[t], v))).astype(np.float32)
                for k, v in p.parameter_size().items()}
            for t, p in processors.items() if t in counts}


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


class Upsample2x(nn.Module):
    def forward(self, x, log_gain):
        return torch.repeat_interleave(torch.exp(log_gain)[..., None] * x, 2, dim=-1)

    def parameter_size(self):
        return {"log_gain": 1}


class CropHalf(nn.Module):
    def forward(self, x, log_gain):
        y = torch.exp(log_gain)[..., None] * x
        return y[..., : y.shape[-1] // 2]

    def parameter_size(self):
        return {"log_gain": 1}


class JUpsample2x:
    def __call__(self, x, log_gain):
        return jnp.repeat(jnp.exp(log_gain)[..., None] * x, 2, axis=-1)


class JCropHalf:
    def __call__(self, x, log_gain):
        y = jnp.exp(log_gain)[..., None] * x
        return y[..., : y.shape[-1] // 2]


def test_one_by_one_ragged_lengths():
    """A chain whose processors change the signal's length renders into
    the one-by-one list buffer, with the reference's shapes, values and
    gradients (``jax.grad``)."""
    L = 2**8
    G = [m[0](config=m[1](["up", "crop"])) for m in (PORT, REF)]
    for g in G:
        g.add_serial_chain(["in", "up", "crop", "crop", "out"])
    plan, jplan = plans(G, "one-by-one")
    procs, jprocs = {"up": Upsample2x(), "crop": CropHalf()}, {"up": JUpsample2x(), "crop": JCropHalf()}
    params = {t: {"log_gain": np.full((2 if t == "crop" else 1, 1), 0.1 * (i + 1), np.float32)}
              for i, t in enumerate(("up", "crop"))}
    x = np.arange(2 * L, dtype=np.float32).reshape(1, 2, L) / L
    pt = parameters_from_numpy(params)
    for leaf in (v for d in pt.values() for v in d.values()):
        leaf.requires_grad_(True)
    out, _, buf = render_grafx(procs, torch.tensor(x), pt, plan)
    jout, _, jbuf = j_render(jprocs, jnp.asarray(x), jax_tree(params), jplan)
    assert isinstance(buf, list) and out.shape == (1, 2, L // 2)
    assert [tuple(b.shape) for b in buf] == [tuple(b.shape) for b in jbuf]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6)
    out.pow(2).mean().backward()
    grads = jax.grad(lambda p: jnp.mean(j_render(jprocs, jnp.asarray(x), p, jplan)[0] ** 2))(
        jax_tree(params))
    for t in params:
        np.testing.assert_allclose(pt[t]["log_gain"].grad.numpy(), np.asarray(grads[t]["log_gain"]),
                                   rtol=1e-5)


def test_one_by_one_matches_batched():
    G = [gain_graph(m) for m in (PORT, REF)]
    params = numpy_params({"gain": StereoGain()}, G[0], 0)
    x = np.random.default_rng(1).standard_normal((3, 2, 2**9)).astype(np.float32)
    outs = {}
    for method in ("beam", "one-by-one"):
        plan, jplan = plans(G, method)
        outs[method] = render_grafx({"gain": StereoGain()}, torch.tensor(x),
                                    parameters_from_numpy(params), plan)[0].numpy()
        ref = j_render({"gain": jp.StereoGain()}, jnp.asarray(x), jax_tree(params), jplan)[0]
        np.testing.assert_allclose(outs[method], np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["one-by-one"], outs["beam"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 2, 2**9), (3, 4, 2, 2**9)])
def test_buffer_modes_agree(shape):
    """Outputs and signal buffers of ``"array"`` and ``"stages"`` (scatter
    fan-in, 3- and 4-dim inputs) agree, and the array buffer equals
    grafx_tpu's."""
    G = [scatter_graph(m) for m in (PORT, REF)]
    plan, jplan = plans(G, "beam")
    params = numpy_params({"gain": StereoGain()}, G[0], 3)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    pt, xt = parameters_from_numpy(params), torch.tensor(x)
    out_a, _, buf_a = render_grafx({"gain": StereoGain()}, xt, pt, plan, buffer_mode="array")
    out_s, _, buf_s = render_grafx({"gain": StereoGain()}, xt, pt, plan, buffer_mode="stages",
                                   return_buffer=True)
    np.testing.assert_allclose(out_a.numpy(), out_s.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(buf_a.numpy(), buf_s.numpy(), rtol=1e-6, atol=1e-7)
    jout, _, jbuf = j_render({"gain": jp.StereoGain()}, jnp.asarray(x), jax_tree(params), jplan,
                             buffer_mode="array")
    np.testing.assert_allclose(buf_a.numpy(), np.asarray(jbuf), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["beam", "one-by-one"])
@pytest.mark.parametrize("mode", ["array", "stages"])
def test_buffer_gradients_match_jax_grad(mode, method):
    """d mean(y^2) through the array buffer (or the one-by-one list, or
    the stage outputs) against ``jax.grad`` of grafx_tpu's render in the
    same mode, for every parameter and the input."""
    G = [scatter_graph(m) for m in (PORT, REF)]
    plan, jplan = plans(G, method)
    procs = {"gain": StereoGain(), "dist": TanhDistortion()}
    params = numpy_params({"gain": StereoGain()}, G[0], 4)
    x = np.random.default_rng(2).standard_normal((4, 2, 2**9)).astype(np.float32)
    pt = parameters_from_numpy(params)
    xt = torch.tensor(x, requires_grad=True)
    for leaf in (v for d in pt.values() for v in d.values()):
        leaf.requires_grad_(True)
    render_grafx(procs, xt, pt, plan, buffer_mode=mode)[0].pow(2).mean().backward()
    jprocs = {"gain": jp.StereoGain(), "dist": jp.TanhDistortion()}
    gp, gx = jax.grad(
        lambda p, a: jnp.mean(j_render(jprocs, a, p, jplan, buffer_mode=mode)[0] ** 2),
        argnums=(0, 1))(jax_tree(params), jnp.asarray(x))
    np.testing.assert_allclose(pt["gain"]["log_gain"].grad.numpy(), np.asarray(gp["gain"]["log_gain"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graph_schedules_and_modes_agree(seed):
    """Random console-style DAGs: the render is the same under every
    schedule and buffer mode (every row of a type equal, so that the
    schedules' row bindings do not matter), and equal to grafx_tpu's."""
    G = [random_console(m, seed)[0] for m in (PORT, REF)]
    num_chains = random_console(PORT, seed)[1]
    procs = {"gain": StereoGain(), "dist": TanhDistortion()}
    jprocs = {"gain": jp.StereoGain(), "dist": jp.TanhDistortion()}
    params = {t: {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in sub.items()}
              for t, sub in numpy_params(procs, G[0], seed).items()}
    x = np.random.default_rng(seed + 10).standard_normal((num_chains, 2, 2**9)).astype(np.float32)
    ref = None
    for method in ("beam", "greedy", "one-by-one"):
        plan, jplan = plans(G, method)
        for mode in ("auto", "array", "stages"):
            out = render_grafx(procs, torch.tensor(x), parameters_from_numpy(params), plan,
                               buffer_mode=mode)[0].numpy()
            ref = out if ref is None else ref
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        jout = j_render(jprocs, jnp.asarray(x), jax_tree(params), jplan)[0]
        np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-6)


def rebind(params, G, method):
    """Per-type rows bound by the beam schedule, rebound to ``method``'s:
    every node keeps its own values."""
    src, dst = _scheduled_type_rows(G, "beam"), _scheduled_type_rows(G, method)
    out = {}
    for t, sub in params.items():
        rows = {dst[n]: src[n] for n in G.nodes if G.nodes[n]["node_type"] == t}
        idx = torch.tensor([rows[r] for r in range(len(rows))])
        out[t] = tree_map(lambda a: a[idx], sub)
    return out


def test_one_by_one_batched_input_matches_beam():
    """A 4-dim input renders one-by-one with each list entry a ``(B, 1, C,
    L)`` row: equal to the beam render of the same parameters on every
    node, and to one-by-one renders of each batch item (grafx_tpu's list
    buffer splits a 4-dim input along the batch and renders only 3-dim
    inputs one-by-one)."""
    G = random_console(PORT, 2)[0]
    procs = {"gain": StereoGain(), "dist": TanhDistortion()}
    params = parameters_from_numpy(numpy_params(procs, G, 5))
    x = torch.randn(3, random_console(PORT, 2)[1], 2, 2**9, generator=torch.Generator().manual_seed(0))
    beam = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    one = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="one-by-one"))
    ref = render_grafx(procs, x, params, beam)[0]
    params_one = rebind(params, G, "one-by-one")
    out, _, buf = render_grafx(procs, x, params_one, one)
    assert all(b.shape[:2] == (3, 1) for b in buf)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    for b in range(3):
        torch.testing.assert_close(render_grafx(procs, x[b], params_one, one)[0], out[b],
                                   rtol=1e-6, atol=1e-7)


def test_one_by_one_multi_outlet_node():
    """A splitter's two outlets land in two list rows, and the merge reads
    each (the same render as the greedy plan's)."""
    config = {"split": {"inlets": ["main"], "outlets": ["low", "high"]},
              "merge": {"inlets": ["a", "b"], "outlets": ["main"]}}
    G = GRAFX(config=NodeConfigs(config))
    i, a, b, o = G.add("in"), G.add("split"), G.add("merge"), G.add("out")
    G.connect(i, a)
    G.connect(a, b, outlet="low", inlet="a")
    G.connect(a, b, outlet="high", inlet="b")
    G.connect(b, o)

    class Splitter(nn.Module):
        def forward(self, x):
            return [0.25 * x, 0.75 * x]

        def parameter_size(self):
            return {}

    class Merger(nn.Module):
        def forward(self, a, b):
            return a - 2.0 * b

        def parameter_size(self):
            return {}

    procs = {"split": Splitter(), "merge": Merger()}
    x = torch.randn(1, 2, 2**9)
    outs = [render_grafx(procs, x, {}, prepare_render(reorder_for_fast_render(convert_to_tensor(G), method=m)))[0]
            for m in ("greedy", "one-by-one")]
    torch.testing.assert_close(outs[1], outs[0])
    torch.testing.assert_close(outs[0], -1.25 * x)


def test_signal_buffer_ops():
    x = torch.randn(2, 3, 2, 16)
    buf = create_signal_buffer("beam", 5, x)
    assert buf.shape == (2, 5, 2, 16) and torch.equal(buf[:, :3], x) and not buf[:, 3:].any()
    new = write_tensor("beam", buf, torch.ones(2, 1, 1, 16), TensorAccess("slice", (3, 4)), dim=1)
    assert torch.equal(new[:, 3], torch.ones(2, 2, 16)) and not buf[:, 3:].any()  # out of place
    new = write_tensor("beam", new, torch.full((2, 2, 2, 16), 2.0), TensorAccess("index", (4, 0)), dim=1)
    assert torch.equal(new[:, 0], torch.full((2, 2, 16), 2.0))
    rows = create_signal_buffer("one-by-one", 5, x[0])
    assert len(rows) == 5 and rows[3] is None and torch.equal(rows[1], x[0, 1:2])
    with pytest.raises(ValueError, match="3- or 4-dim"):
        create_signal_buffer("beam", 5, x[0, 0])
    with pytest.raises(ValueError, match="buffer_mode"):
        render_grafx({}, x[0], {}, prepare_render(reorder_for_fast_render(
            convert_to_tensor(gain_graph(PORT)), method="beam")), buffer_mode="threaded")


def test_make_render_fn_options():
    """``make_render_fn`` takes ``donate_buffer`` (unused) and
    ``buffer_mode``; a one-by-one plan runs eagerly under ``jit``, every
    other plan is captured; ``render_grafx`` takes ``parameters_grad`` and
    ``input_signal_grad`` (ignored); streaming refuses one-by-one plans."""
    G = gain_graph(PORT)
    procs = {"gain": StereoGain()}
    params = parameters_from_numpy(numpy_params(procs, G, 0))
    x = torch.randn(3, 2, 256)
    beam = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    one = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="one-by-one"))
    assert isinstance(make_render_fn(procs, beam, buffer_mode="array"), CapturedFunction)
    assert not isinstance(make_render_fn(procs, one), CapturedFunction)
    y, _, buf = make_render_fn(procs, beam, donate_buffer=True, buffer_mode="array")(x, params)
    assert buf.shape == (2 * 3 + 2, 2, 256)
    ref = render_grafx(procs, x, params, beam, parameters_grad=False, input_signal_grad=True)[0]
    torch.testing.assert_close(y, ref)
    with pytest.raises(ValueError, match="scheduled plan"):
        StreamRenderer(procs, one, params, block_len=256)


def test_one_by_one_optimizer_step_matches_grafx_tpu(monkeypatch):
    """``GraphParameterOptimizer(method="one-by-one")`` on the bench.py
    console (fused ``"pad-auto"``, MSE, SGD 1e-3): two steps from
    grafx_tpu's initial parameters on a 3-dim input (grafx_tpu's one-by-one
    executor takes no 4-dim input), the losses within rtol 1e-4 of
    grafx_tpu's and the parameters after them within 1e-5."""
    monkeypatch.setattr(bench, "NUM_CHAINS", 3)
    opt_j = JOptimizer(bench.build_mix_graph(), jax_processors(), loss_fn=jlosses.mse_loss,
                       optimizer=optax.sgd(1e-3), fuse="pad-auto", key=jax.random.PRNGKey(3),
                       method="one-by-one")
    trainer = GraphParameterOptimizer(bench_graph(3), bench_processors(), loss_fn=losses.mse_loss,
                                      optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3),
                                      fuse="pad-auto", device="cpu", method="one-by-one")
    assert trainer.render_data.method == "one-by-one"
    start = dict(tree_items(jax.tree.map(np.asarray, opt_j.params)))
    with torch.no_grad():
        for k, p in tree_items(trainer.params):
            p.copy_(torch.tensor(start[k]))
    rng = np.random.default_rng(5)
    x = console_input(rng, (3, 2, 2**11))
    target = rng.standard_normal((1, 2, 2**11)).astype(np.float32)
    history_j = opt_j.fit(x, target, num_steps=2)
    history = trainer.fit(torch.tensor(x), torch.tensor(target), num_steps=2)
    np.testing.assert_allclose(history, history_j, rtol=1e-4)
    end = dict(tree_items(jax.tree.map(np.asarray, opt_j.params)))
    for k, p in tree_items(trainer.params):
        np.testing.assert_allclose(p.detach().numpy(), end[k], rtol=1e-5, atol=1e-5, err_msg=k)
    y = trainer.render_current(torch.tensor(x))
    assert y.shape == (1, 2, 2**11) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("method,mode", [("greedy", "auto"), ("fixed", "auto"), ("one-by-one", "auto"),
                                         ("beam", "array")])
def test_console_schedules_match_grafx_tpu(method, mode, monkeypatch):
    """The fused bench.py console (3 chains, L = 2^12, one request: grafx_tpu
    renders one-by-one plans from 3-dim inputs only) under each schedule
    and the array buffer, against grafx_tpu's render of the same plan on
    the same numpy parameters migrated by both packages' fuse_parameters
    (the fixed plan takes the beam's type sequence, so it binds as the
    beam plan does): within -60 dB, as ``test_torch_render``."""
    from grafx_tpu.render import fuse_parameters as j_fuse_parameters
    from grafx_tpu.render import fuse_serial_lti as j_fuse
    from grafx_tpu.render import make_render_fn as j_make_render_fn
    from grafx_tpu.render.order import compute_render_order as j_order
    from grafx_tpu_torch.models import bench_console
    from grafx_tpu_torch.render import compute_render_order, fuse_parameters
    from test_torch_graph import FUSE

    monkeypatch.setattr(bench, "NUM_CHAINS", 3)
    Gj = bench.build_mix_graph()
    procs_j = jax_processors()
    params_j = jax.tree.map(np.asarray, j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(7)))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    c = bench_console(3, device="cpu")
    migrate, kw = method, {}
    if method == "fixed":
        migrate, kw = "beam", {"fixed_order": compute_render_order(c.fused_graph, method="beam")[0]}
        np.testing.assert_array_equal(kw["fixed_order"], j_order(Gj2, method="beam")[0])
    params = fuse_parameters(parameters_from_numpy(params_j), c.graph, c.fused_graph, c.fused_processors,
                             method=migrate)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, method=migrate)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(c.fused_graph), method=method, **kw))
    plan_j = j_prepare(j_reorder(j_convert(Gj2), method=method, **kw))
    x = np.random.default_rng(11).standard_normal((3, 2, 2**12)).astype(np.float32)
    with torch.inference_mode():
        y = make_render_fn(c.fused_processors, plan, buffer_mode=mode)(torch.tensor(x), params)[0].numpy()
    ref = np.asarray(j_make_render_fn(procs_j2, plan_j, buffer_mode=mode)(jnp.asarray(x), params_j2)[0])
    assert y.shape == ref.shape == (1, 2, 2**12)
    err = 20 * np.log10(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    assert err <= -60.0, err
