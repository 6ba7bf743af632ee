"""The frequency-sampled (fsm) IIR backend, the default of IIRFilter in both
packages, and the sequential "scan" oracle: ops/iir.py's FSM functions,
IIRFilter's fsm branch (forward, stream, gradient), and the bench.py
console built on fsm equalizers (3 chains, L = 2^13), served and trained,
by grafx_tpu_torch against grafx_tpu on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.ops import iir as jiir
from grafx_tpu.processors.core.iir import IIRFilter as JIIRFilter
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops import iir
from grafx_tpu_torch.processors.core.iir import IIRFilter
from grafx_tpu_torch.render import FusedFIRChain, fuse_parameters, make_render_fn
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map
from test_torch_graph import FUSE
from test_torch_train import console_input

REL = 1e-5  # rel. to max|ref|
NUM_CHAINS, BATCH, L = 3, 2, 2**13


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def stable_biquads(rng, shape, r_hi=0.97):
    """Random stable sections ``shape + (3,)``: poles of radius 0.1-r_hi."""
    r = rng.uniform(0.1, r_hi, shape)
    th = rng.uniform(0.05, np.pi - 0.05, shape)
    As = np.stack([np.ones_like(r), -2 * r * np.cos(th), r**2], -1)
    Bs = rng.standard_normal(shape + (3,))
    return Bs, As


@pytest.mark.parametrize("K, fir_len", [(1, 4000), (6, 4000), (24, 4000), (5, 511)])
def test_iir_fsm_fir_matches_grafx_tpu(K, fir_len):
    rng = np.random.default_rng(K)
    Bs, As = (a.astype(np.float32) for a in stable_biquads(rng, (3, 2, K)))
    np.testing.assert_array_equal(
        iir.fsm_delay_phasors(2, fir_len).numpy(), np.asarray(jiir.fsm_delay_phasors(2, fir_len))
    )
    ref = np.asarray(jiir.iir_fsm_fir(jnp.asarray(Bs), jnp.asarray(As), fir_len))
    got = iir.iir_fsm_fir(torch.tensor(Bs), torch.tensor(As), fir_len).numpy()
    assert got.shape == ref.shape == (3, 2, fir_len)
    assert max_rel(got, ref) <= REL, max_rel(got, ref)


def test_scan_oracle_matches_exact_and_scipy():
    """The scan oracle and the exact backend against scipy's lfilter in
    float64, at the bound tests/processors/test_filter.py holds them to
    (atol 1e-8); and IIRFilter(backend="scan") against grafx_tpu's."""
    rng = np.random.default_rng(0)
    N, K, length = 4, 3, 2**12
    Bs, As = stable_biquads(rng, (N, K))
    x = rng.standard_normal((N, length))
    y_ref = x.copy()
    for n in range(N):
        for k in range(K):
            y_ref[n] = scipy.signal.lfilter(Bs[n, k], As[n, k], y_ref[n])
    t = torch.tensor
    y_scan = iir.biquad_scan(t(x), t(Bs), t(As)).numpy()
    y_exact = iir.biquad_exact(t(x), t(Bs), t(As), block_size=256).numpy()
    np.testing.assert_allclose(y_scan, y_ref, atol=1e-8)
    np.testing.assert_allclose(y_exact, y_ref, atol=1e-8)
    np.testing.assert_allclose(y_scan, y_exact, atol=1e-8)

    x32 = x[:, None, :512].astype(np.float32)
    B32, A32 = Bs[:, None].astype(np.float32), As[:, None].astype(np.float32)
    ref = np.asarray(JIIRFilter(backend="scan")(jnp.asarray(x32), jnp.asarray(B32), jnp.asarray(A32)))
    scan = IIRFilter(backend="scan")
    got = scan(t(x32), t(B32), t(A32)).numpy()
    assert max_rel(got, ref) <= REL
    np.testing.assert_array_equal(scan(t(x32), cache=scan.precompute(t(B32), t(A32))).numpy(), got)
    with pytest.raises(NotImplementedError, match="scan"):
        scan.stream_zero_state(scan.precompute(t(B32), t(A32)), 1, 128)


def fsm_inputs(seed=1, C_f=1, K=4, length=2**12):
    rng = np.random.default_rng(seed)
    Bs, As = (a.astype(np.float32) for a in stable_biquads(rng, (3, C_f, K), r_hi=0.99))
    x = rng.standard_normal((3, 2, length)).astype(np.float32)
    return x, Bs, As


@pytest.mark.parametrize("C_f", [1, 2])
def test_fsm_filter_forward_and_stream_match_grafx_tpu(C_f):
    """IIRFilter's fsm branch, from coefficients and from its precompute
    cache, and streamed in blocks of 1000 (shorter than the FIR: the tail
    spans blocks), against grafx_tpu's one-shot and streamed output."""
    x, Bs, As = fsm_inputs(C_f=C_f)
    jf, tf = JIIRFilter(backend="fsm"), IIRFilter()
    ref = np.asarray(jf(jnp.asarray(x), jnp.asarray(Bs), jnp.asarray(As)))
    t = torch.tensor
    assert max_rel(tf(t(x), t(Bs), t(As)).numpy(), ref) <= REL
    cache = tf.precompute(t(Bs), t(As))
    assert set(cache) == {"firs"} and cache["firs"].shape == (3, C_f, 4000)
    assert max_rel(tf(t(x), cache=cache).numpy(), ref) <= REL

    jcache = jf.precompute(jnp.asarray(Bs), jnp.asarray(As))
    jstate = jf.stream_zero_state(jcache, 2, 1000)
    state = tf.stream_zero_state(cache, 2, 1000)
    assert tuple(state.shape) == jstate.shape
    got, want = [], []
    for lo in range(0, 4000, 1000):
        y, state = tf.stream(t(x[..., lo:lo + 1000]), state, cache)
        yj, jstate = jf.stream(jnp.asarray(x[..., lo:lo + 1000]), jstate, jcache)
        got.append(y.numpy())
        want.append(np.asarray(yj))
    assert max_rel(np.concatenate(got, -1), np.concatenate(want, -1)) <= REL
    assert max_rel(np.concatenate(got, -1), ref[..., :4000]) <= REL


def test_fsm_filter_gradient_matches_grafx_tpu():
    """The gradient of a weighted sum of the fsm output w.r.t. Bs and As
    (through the complex response, its product over sections and the
    irfft) against jax.grad: <= -60 dB each."""
    x, Bs, As = fsm_inputs(seed=2, K=6)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jf = JIIRFilter(backend="fsm")

    def f_j(b, a):
        return jnp.sum(jf(jnp.asarray(x), b, a) * w)

    gB_j, gA_j = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(Bs), jnp.asarray(As))
    b, a = torch.tensor(Bs, requires_grad=True), torch.tensor(As, requires_grad=True)
    (IIRFilter()(torch.tensor(x), b, a) * torch.tensor(w)).sum().backward()
    assert db(b.grad.numpy() - np.asarray(gB_j), np.asarray(gB_j)) <= -60.0
    assert db(a.grad.numpy() - np.asarray(gA_j), np.asarray(gA_j)) <= -60.0


def jax_fsm_processors():
    return {
        "eq": jp.ParametricEqualizer(num_filters=6, backend="fsm"),
        "geq": jp.GraphicEqualizer(scale="bark", backend="fsm"),
        "compressor": jp.Compressor(energy_smoother="ballistics"),
        "noisegate": jp.NoiseGate(energy_smoother="iir_exact"),
        "gain": jp.StereoGain(),
        "dist": jp.TanhDistortion(),
        "reverb": jp.STFTMaskedNoiseReverb(ir_len=30000),
    }


def fsm_processors():
    return bench_processors(backend="fsm")


@pytest.fixture(scope="module")
def fsm_console():
    """grafx_tpu's fsm console (3 chains) fused as bench.py fuses it, its
    parameters drawn on the unfused graph and migrated, the render and
    the MSE loss's value and gradient (jax.value_and_grad); and
    the port's console and trainer with the same parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
        Gj = bench.build_mix_graph()
    procs_j = jax_fsm_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(3))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    render_j = j_make_render_fn(
        procs_j2, j_prepare(j_reorder(j_convert(Gj2), method="beam", use_native=False))
    )
    rng = np.random.default_rng(13)
    x = console_input(rng, (BATCH, NUM_CHAINS, 2, L))
    target = rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32)

    def loss_j(p):
        return jnp.mean((render_j(x, p)[0] - target) ** 2)

    y_j = np.asarray(render_j(x, params_j2)[0])
    value_j, grads_j = jax.jit(jax.value_and_grad(loss_j))(params_j2)

    c = bench_console(NUM_CHAINS, device="cpu", processors=fsm_processors())
    migrated = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    with torch.inference_mode():
        y = make_render_fn(c.fused_processors, c.plan)(torch.tensor(x), migrated)[0].numpy()
    trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=fsm_processors())
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), trainer.params, migrated)
    total, audio = trainer.loss(torch.tensor(x), torch.tensor(target))
    total.backward()
    grads = tree_map(lambda p: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy(),
                     trainer.params)
    return dict(
        y=y, y_j=y_j, loss=audio.item(), loss_j=float(value_j), graph=c.fused_graph,
        graph_j=Gj2, types=c.fused_processors, types_j=procs_j2,
        grads=dict(tree_items(grads)), grads_j=dict(tree_items(jax.tree.map(np.asarray, grads_j))),
    )


def test_fsm_console_fuses_like_grafx_tpu(fsm_console):
    """eq -> geq folds into FusedFIRChain (on the chains that have a geq),
    the master eq -> gain into another; the fused graph is grafx_tpu's."""
    types = fsm_console["types"]
    fused = sorted(t for t in types if t.startswith("fused("))
    assert fused == sorted(t for t in fsm_console["types_j"] if t.startswith("fused("))
    assert fused == ["fused(eq+gain)", "fused(eq+geq)", "fused(noisegate+compressor)"]
    assert isinstance(types["fused(eq+geq)"], FusedFIRChain)
    assert isinstance(types["fused(eq+gain)"], FusedFIRChain)
    assert fsm_console["graph"].graph["fused_from"] == fsm_console["graph_j"].graph["fused_from"]


def test_fsm_console_render_matches_grafx_tpu(fsm_console):
    y, ref = fsm_console["y"], fsm_console["y_j"]
    assert y.shape == ref.shape == (BATCH, 1, 2, L)
    assert np.isfinite(y).all()
    assert db(y - ref, ref) <= -60.0, db(y - ref, ref)


def test_fsm_console_step_matches_grafx_tpu(fsm_console):
    """The MSE step's loss and concatenated gradient <= -60 dB against
    jax.value_and_grad; leaves zero in JAX are zero in the port."""
    loss, ref = fsm_console["loss"], fsm_console["loss_j"]
    assert db(np.float64(loss) - ref, np.float64(ref)) <= -60.0
    got, want = fsm_console["grads"], fsm_console["grads_j"]
    assert got.keys() == want.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert np.isfinite(cat(got)).all()
    assert db(cat(got) - cat(want), cat(want)) <= -60.0
    for k in want:
        if not np.any(want[k] != 0):
            assert np.all(got[k] == 0), k
    # the fsm FIRs pass gradient to every equalizer leaf
    for k in want:
        if "eq" in k and not k.endswith("_absent"):
            assert np.any(got[k] != 0), k


@pytest.mark.parametrize("path", ["request", "step", "stream block", "fused-delay step"])
def test_warm_fsm_path_makes_no_host_tensor(path):
    """A CUDA-graph capture refuses a tensor made from host data and a
    device value read on the host: no warm fsm path, which builds its
    FIRs on every call, does either."""
    from test_torch_compiled import HostOps

    rng = np.random.default_rng(6)
    x = torch.tensor(console_input(rng, (1, NUM_CHAINS, 2, 2**12)))
    target = torch.tensor(rng.standard_normal((1, 1, 2, 2**12)).astype(np.float32))
    if path == "fused-delay step":
        from grafx_tpu_torch.models import GraphParameterOptimizer, mixing_console

        G, procs = mixing_console(3, track_chain=("eq", "compressor", "gain", "delay"),
                                  backend="fsm", ir_len=2000)
        opt = GraphParameterOptimizer(G, procs, device="cpu", fuse=True,
                                      optimizer=lambda p: torch.optim.SGD(p, lr=1e-3))
        run = lambda: opt.step(x[0], target[0])  # noqa: E731
    elif path == "step":
        trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=fsm_processors())
        run = lambda: trainer.step(x, target)  # noqa: E731
    else:
        c = bench_console(NUM_CHAINS, device="cpu", processors=fsm_processors())
        if path == "request":
            render = make_render_fn(c.fused_processors, c.plan)
            run = lambda: render(x, c.params)  # noqa: E731
        else:
            from grafx_tpu_torch.render import StreamRenderer

            streamer = StreamRenderer(c.fused_processors, c.plan, c.params, block_len=1024)
            state = streamer.init_state()
            run = lambda: streamer(x[0, ..., :1024], state)  # noqa: E731
    with torch.inference_mode(path in ("request",)):
        run()
        with HostOps() as ops:
            run()
    assert ops.seen == []
