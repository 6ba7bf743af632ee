"""The serving export of grafx_tpu_torch (``serving.py`` on torch.export),
mirroring tests/test_serving.py: renders of a plain and a fused plan and
the stream step round-trip through saved artifacts and replay equal to
the live port; the render artifacts also against grafx_tpu's own
``jax.export`` round trip on the same numpy inputs and parameters; and
the three ballistics custom ops and the frame gain's pass
``torch.library.opcheck``."""

import io

import jax
import numpy as np
import pytest
import torch

import bench
from grafx_tpu import processors as jp
from grafx_tpu import serving as jserving
from grafx_tpu.data import GRAFX as JGRAFX
from grafx_tpu.data import NodeConfigs as JNodeConfigs
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models import bench_console
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.render import (
    StreamRenderer,
    fuse_parameters,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.serving import (
    export_render,
    export_stream_step,
    load_render,
    load_stream_step,
)
from grafx_tpu_torch.utils import parameters_from_numpy, tree_map
from test_torch_graph import FUSE, jax_processors

L, BLOCK, CHAINS = 2**12, 1024, 3


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def _plain_processors(pkg):
    """tests/test_serving.py's three chains, with the ballistics
    compressor (kernel #2, the custom op ``ballistics_gain``)."""
    return {
        "gain": pkg.StereoGain(),
        "eq": pkg.ParametricEqualizer(num_filters=2, backend="exact"),
        "comp": pkg.Compressor(energy_smoother="ballistics"),
    }


def _plain_graph(grafx, node_configs):
    G = grafx(config=node_configs(["gain", "eq", "comp"]))
    ends = [G.add_serial_chain(["in", "eq", "comp", "gain"])[1] for _ in range(CHAINS)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G


def _jax_plan(G):
    return j_prepare(j_reorder(j_convert(G), method="beam", use_native=False))


@pytest.fixture(scope="module")
def plain():
    """The plain plan in both packages, the same parameters (std 0.3, so
    the compressors act) and inputs."""
    procs_j = _plain_processors(jp)
    Gj = _plain_graph(JGRAFX, JNodeConfigs)
    params_j = jax.tree.map(np.asarray, j_create_params(procs_j, Gj, std=0.3, key=jax.random.PRNGKey(0)))
    procs = _plain_processors(tp)
    G = _plain_graph(GRAFX, NodeConfigs)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    x = np.random.default_rng(1).standard_normal((2, CHAINS, 2, L)).astype(np.float32)
    return dict(render=make_render_fn(procs, plan), params=parameters_from_numpy(params_j),
                render_j=j_make_render_fn(procs_j, _jax_plan(Gj)), params_j=params_j, x=x)


@pytest.fixture(scope="module")
def fused():
    """The bench.py console of CHAINS chains, fused (kernel #1 at the gate
    chain, #2 at the bus compressors): grafx_tpu's fused render with its
    migrated parameters, and the port's with the same migration."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", CHAINS)
        Gj = bench.build_mix_graph()
    procs_j = jax_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(7))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    c = bench_console(CHAINS, device="cpu")
    params = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    x = np.random.default_rng(11).standard_normal((2, CHAINS, 2, L)).astype(np.float32)
    return dict(render=make_render_fn(c.fused_processors, c.plan), params=params,
                render_j=j_make_render_fn(procs_j2, _jax_plan(Gj2)),
                params_j=jax.tree.map(np.asarray, params_j2), x=x, console=c)


def jax_fsm_processors():
    """bench.py's processors with the equalizers on the fsm backend."""
    return {**jax_processors(), "eq": jp.ParametricEqualizer(num_filters=6, backend="fsm"),
            "geq": jp.GraphicEqualizer(scale="bark", backend="fsm")}


@pytest.fixture(scope="module")
def fsm():
    """The fused console of CHAINS chains on fsm equalizers
    (``bench_processors(backend="fsm")``: its FusedFIRChains carry complex
    FIR spectra), as :func:`fused` builds the exact one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", CHAINS)
        Gj = bench.build_mix_graph()
    procs_j = jax_fsm_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(7))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    c = bench_console(CHAINS, device="cpu", processors=bench_processors(backend="fsm"))
    params = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    x = np.random.default_rng(12).standard_normal((2, CHAINS, 2, L)).astype(np.float32)
    return dict(render=make_render_fn(c.fused_processors, c.plan), params=params,
                render_j=j_make_render_fn(procs_j2, _jax_plan(Gj2)),
                params_j=jax.tree.map(np.asarray, params_j2), x=x, console=c)


@pytest.mark.parametrize("graph", ["plain", "fused", "fsm"])
def test_export_render_roundtrip(graph, request):
    """The loaded artifact equals the live render bit for bit, replays
    fresh parameter values, and is within -60 dB of grafx_tpu's own
    export round trip on the same inputs and parameters."""
    g = request.getfixturevalue(graph)
    x = torch.tensor(g["x"])
    blob = export_render(g["render"], x, g["params"])
    assert isinstance(blob, bytes) and len(blob) > 0
    served = load_render(blob)
    with torch.inference_mode():
        live = g["render"](x, g["params"])[0]
    out = served(x, g["params"])
    assert torch.equal(out, live)

    params2 = tree_map(lambda v: v + 0.01, g["params"])
    with torch.inference_mode():
        live2 = g["render"](x, params2)[0]
    out2 = served(x, params2)
    assert torch.equal(out2, live2)
    assert not torch.equal(out2, out)

    ref = np.asarray(jserving.load_render(jserving.export_render(g["render_j"], g["x"], g["params_j"]))(
        g["x"], g["params_j"]))
    assert out.shape == ref.shape
    assert db(out.numpy() - ref, ref) <= -60.0, db(out.numpy() - ref, ref)


def _streamer(fused):
    c = fused["console"]
    return StreamRenderer(c.fused_processors, c.plan, fused["params"], block_len=BLOCK)


def test_export_stream_step_roundtrip(fused):
    """The exported streaming step reproduces the live StreamRenderer
    block for block, bit for bit, from the shipped initial state (string
    keys at the boundary)."""
    live = _streamer(fused)
    x = torch.tensor(fused["x"][0])
    step, state = load_stream_step(export_stream_step(live, x[..., :BLOCK]))
    assert set(state) == {str(k) for k in live.init_state()}
    live_state = live.init_state()
    for k in range(L // BLOCK):
        xb = x[..., k * BLOCK:(k + 1) * BLOCK]
        y_live, live_state = live(xb, live_state)
        y_exp, state = step(xb, state)
        assert torch.equal(y_exp, y_live), k


def test_export_stream_step_roundtrip_fsm(fsm):
    """The fsm console's stream step (its FIR chains streamed by UPOLS
    from complex spectra) exported for one block and for four, each
    against the live StreamRenderer: one block bit for bit, four within
    the JAX test's bound."""
    live = _streamer(fsm)
    x = torch.tensor(fsm["x"][0])
    step, state = load_stream_step(export_stream_step(live, x[..., :BLOCK]))
    live_state = live.init_state()
    singles = []
    for k in range(L // BLOCK):
        xb = x[..., k * BLOCK:(k + 1) * BLOCK]
        y_live, live_state = live(xb, live_state)
        y_exp, state = step(xb, state)
        assert torch.equal(y_exp, y_live), k
        singles.append(y_live)
    x_blocks = torch.stack(x.split(BLOCK, dim=-1))
    many, state = load_stream_step(export_stream_step(live, x_blocks[0], blocks_per_step=len(x_blocks)))
    y_many, _ = many(x_blocks, state)
    for y, ref in zip(y_many, singles):
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)


def test_export_stream_step_multiblock(fused):
    """``blocks_per_step=k`` exports ``step_many``: one call equals k
    live single-block calls (the JAX test's bound)."""
    live = _streamer(fused)
    x = torch.tensor(fused["x"][1])
    k = L // BLOCK
    x_blocks = torch.stack(x.split(BLOCK, dim=-1))
    step, state = load_stream_step(export_stream_step(live, x_blocks[0], blocks_per_step=k))
    y_many, _ = step(x_blocks, state)
    assert y_many.shape == (k, 1, 2, BLOCK)
    live_state = live.init_state()
    for i, xb in enumerate(x_blocks):
        y_live, live_state = live(xb, live_state)
        np.testing.assert_allclose(y_many[i].numpy(), y_live.numpy(), rtol=2e-5, atol=2e-6)


def test_export_stream_step_blocks_of_part_links():
    """A stream of blocks that are not whole links (444 samples): its
    walks' states carry the samples of the link each block ended in, whose
    count changes from block to block, so the artifact holds one program
    per state shape the stream reaches (two here), and the loaded step
    equals the live StreamRenderer bit for bit over more blocks than that."""
    block = 444
    procs = {"chain": tp.Compressor(energy_smoother="ballistics", gain_smoother="ballistics"),
             "comp": tp.Compressor(energy_smoother="ballistics")}
    G = GRAFX(config=NodeConfigs(sorted(procs)))
    ends = [G.add_serial_chain(["in", kind])[1] for kind in ("chain", "comp")]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    rng = np.random.default_rng(4)
    params = parameters_from_numpy({t: {k: (0.3 * rng.standard_normal((1, n))).astype(np.float32)
                                        for k, n in p.parameter_size().items()}
                                    for t, p in procs.items()})
    live = StreamRenderer(procs, plan, params, block_len=block)
    x = torch.tensor(rng.standard_normal((2, 2, 5 * block)).astype(np.float32))
    blob = export_stream_step(live, x[..., :block])
    assert len(torch.load(io.BytesIO(blob), weights_only=True)["programs"]) == 2
    step, state = load_stream_step(blob)
    live_state = live.init_state()
    for k in range(5):
        xb = x[..., k * block:(k + 1) * block]
        y_live, live_state = live(xb, live_state)
        y_exp, state = step(xb, state)
        assert torch.equal(y_exp, y_live), k


def _op_args(op, rng):
    n, length = 5, 300
    u = torch.tensor(np.abs(rng.standard_normal((n, length))).astype(np.float32))

    def consts(k):
        return [torch.tensor(rng.uniform(0.05, 0.9, n).astype(np.float32)) for _ in range(k)]

    if op == "ballistics_gain_pair":
        return (u, consts(10), "noisegate", "compressor", 0.0, 1.0)
    if op == "ballistics_gain":
        return (u, consts(6), "compressor")
    if op == "frame_gain":
        return (u, consts(5), 64)
    return (u, consts(3))


@pytest.mark.parametrize("op", ["ballistics_gain_pair", "ballistics_gain", "ballistics", "frame_gain"])
def test_custom_ops_pass_opcheck(op):
    """Kernels #1, #2 and #7 and the frame gain's primal as custom ops:
    schema, fake implementation and dispatch pass
    ``torch.library.opcheck``, and the op is the plain version on the
    CPU."""
    args = _op_args(op, np.random.default_rng(3))
    overload = getattr(torch.ops.grafx_tpu_torch, op).default
    torch.library.opcheck(overload, args)
    plain = {"ballistics_gain_pair": lambda u, c, ka, kb, ia, ib: bal.ballistics_gain_pair_plain(
                 u, *c, kinds=(ka, kb), inits=(ia, ib)),
             "ballistics_gain": lambda u, c, kind: bal.ballistics_gain_plain(u, *c, kind),
             "ballistics": lambda u, c: bal.ballistics_plain(u, *c),
             "frame_gain": lambda u, c, frame_len: bal.frame_gain_plain(u, *c, frame_len)}[op]
    assert torch.equal(overload(*args), plain(*args))
