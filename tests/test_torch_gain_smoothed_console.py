"""The gain-smoothed console against grafx_tpu: bench.py's console at 3
chains (chain 0 carries a gate), batch 2, L = 2^12, with its compressor
and gate smoothing their gains,

    "compressor": Compressor(energy_smoother="ballistics", gain_smoother="ballistics")
    "noisegate": NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                           gain_smooth_in_log=True)

the two composed configurations of tests/test_torch_dynamics.py, fused as
bench.py fuses it (kinds fir, iir and dynamics, dynamics_pad "auto") from
grafx_tpu's parameters drawn on the unfused graph and migrated.  A gate ->
compressor composite with a gain smoother takes no pair walk in either
package: its members compose (each smoother the ballistics walk, #7; under
autograd #8 and #9).  Compared: the fused plan's types, the request's
render, the MSE step's loss and every parameter gradient (inputs with
-40 dB passages, which engage the gate), and the stream against
grafx_tpu's StreamRenderer; and the plain versions a request, a step and
a block call.

Bounds.  In float32 the render, the loss, the concatenated gradient and
the stream within -60 dB of grafx_tpu's (tests/test_torch_render.py's
console render, tests/test_torch_train.py's step,
tests/test_torch_stream.py's stream).  A leaf's gradient is another
matter: the gate's and the composite compressor's leaves are determined
only to -18 to -44 dB by float32 itself (each package's float32 gradient
against its float64 one; the gate's attack/release decisions on the
smoothed log gain and the knee's few samples flip under rounding), while
the two packages' float64 gradients agree to -115 dB or better.  So, as
tests/test_torch_examples.py does, the step is also taken in float64
(the port's processors and inputs in double, grafx_tpu's under
jax.enable_x64): there every leaf within GRAD_DB, the bound
tests/test_torch_dynamics.py holds these configurations' parameters to;
and in float32 each leaf no further from grafx_tpu's float64 gradient
than grafx_tpu's own float32 one is, plus 6 dB (the CPU's own spread
plus 6 dB, as chip_smoke.py holds the MR-STFT gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import StreamRenderer as JStreamRenderer
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.render import StreamRenderer, fuse_parameters, make_render_fn
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map
from test_torch_graph import FUSE, jax_processors
from test_torch_train import PLAIN_VERSIONS, absent_rows, console_input, count_calls, db

NUM_CHAINS, BATCH, L, BLOCK = 3, 2, 2**12, 1024
GRAD_DB = -60.0  # tests/test_torch_dynamics.py: each dynamics parameter's gradient
PAIR = "fused(noisegate+compressor)"
# the dynamics chain calls of one run: the composites' (gate energy and
# gain, compressor energy and gain) and the bus compressors' (energy, gain)
CHAIN_CALLS = 2
CHAIN_PLAIN = ("ballistics_chain_plain", "ballistics_chain_fwd_plain", "ballistics_chain_bwd_plain")


def gain_smoothed(lib):
    return {
        "compressor": lib.Compressor(energy_smoother="ballistics", gain_smoother="ballistics"),
        "noisegate": lib.NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                                   gain_smooth_in_log=True),
    }


def port_processors():
    return {**bench_processors(), **gain_smoothed(tp)}


def float64(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float64), tree)


def stream(streamer, x):
    state, outs = streamer.init_state(), []
    for i in range(0, x.shape[-1], BLOCK):
        y, state = streamer(x[..., i:i + BLOCK], state)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1)


@pytest.fixture(scope="module")
def run():
    procs_j = {**jax_processors(), **gain_smoothed(jp)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
        Gj = bench.build_mix_graph()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(15))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    plan_j = j_prepare(j_reorder(j_convert(Gj2), method="beam", use_native=False))
    render_j = j_make_render_fn(procs_j2, plan_j)
    rng = np.random.default_rng(15)
    x = console_input(rng, (BATCH, NUM_CHAINS, 2, L))
    target = rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32)

    def loss_j(p):
        y = render_j(x.astype(p["gain"]["log_gain"].dtype), p)[0]
        return jnp.mean((y - target) ** 2), y

    (value_j, render_ref), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j2)
    with jax.enable_x64(True):
        grads_j64 = jax.jit(jax.grad(lambda p: loss_j(p)[0]))(float64(params_j2))
    stream_j = stream(JStreamRenderer(procs_j2, plan_j, params_j2, block_len=BLOCK), jnp.asarray(x[0]))

    c = bench_console(NUM_CHAINS, device="cpu", processors=port_processors())
    migrated = fuse_parameters(parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
                               c.graph, c.fused_graph, c.fused_processors)
    trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=port_processors())
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), trainer.params, migrated)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        calls["step"] = count_calls(mp, bal, PLAIN_VERSIONS + CHAIN_PLAIN)
        total, audio = trainer.loss(torch.tensor(x), torch.tensor(target))
        total.backward()
    grads = tree_map(lambda p: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy(),
                     trainer.params)
    trainer64 = bench_trainer(NUM_CHAINS, device="cpu", processors=port_processors(), jit=False)
    for proc in trainer64.processors.values():
        proc.double()
    trainer64.params = tree_map(lambda v, p: v.double().requires_grad_(p.requires_grad), migrated, trainer.params)
    trainer64.loss(torch.tensor(x).double(), torch.tensor(target).double())[0].backward()
    grads64 = tree_map(lambda p: np.zeros(p.shape) if p.grad is None else p.grad.numpy(), trainer64.params)
    with pytest.MonkeyPatch.context() as mp:
        calls["request"] = count_calls(mp, bal, PLAIN_VERSIONS + CHAIN_PLAIN)
        with torch.inference_mode():
            y = make_render_fn(c.fused_processors, c.plan)(torch.tensor(x), migrated)[0]
    streamer = StreamRenderer(c.fused_processors, c.plan, migrated, block_len=BLOCK)
    with pytest.MonkeyPatch.context() as mp:
        calls["stream"] = count_calls(mp, bal, PLAIN_VERSIONS + CHAIN_PLAIN)
        streamed = stream(streamer, torch.tensor(x[0]))
    return dict(
        console=c, Gj2=Gj2, procs_j2=procs_j2,
        render=y.numpy(), render_j=np.asarray(render_ref),
        loss=audio.item(), total=total.item(), loss_j=float(value_j),
        grads=dict(tree_items(grads)), grads_j=dict(tree_items(jax.tree.map(np.asarray, grads_j))),
        grads64=dict(tree_items(grads64)), grads_j64=dict(tree_items(jax.tree.map(np.asarray, grads_j64))),
        absent=absent_rows(jax.tree.map(np.asarray, params_j2)),
        stream=streamed, stream_j=stream_j, calls=calls,
    )


def test_fused_plan_matches_grafx_tpu(run):
    """The same fused node types in both packages: the gain smoothers
    leave the gate -> compressor runs fused as composites (the bench
    console's types), but neither package's composite takes the pair
    walk (#1, #3/#4): grafx_tpu's members compose, the port's run the
    dynamics chain op."""
    types = lambda G: sorted(d["node_type"] for _, d in G.nodes(data=True))  # noqa: E731
    c = run["console"]
    assert types(c.fused_graph) == types(run["Gj2"])
    assert PAIR in c.fused_processors and PAIR in run["procs_j2"]
    params = c.params[PAIR]
    assert c.fused_processors[PAIR].gain_op == ("chain", (("noisegate", "log"), ("compressor", "linear")))
    assert run["procs_j2"][PAIR]._pair_kernel_args(
        jax.tree.map(lambda v: jnp.asarray(v.numpy()), params)) is None
    for _, proc in c.fused_processors[PAIR].members:
        assert proc.gain_smoother == "ballistics" and proc.gain_op.name == "chain"


def test_render_matches_grafx_tpu(run):
    got, ref = run["render"], run["render_j"]
    assert got.shape == ref.shape == (BATCH, 1, 2, L) and np.isfinite(got).all()
    assert db(got - ref, ref) <= -60.0, db(got - ref, ref)


def test_step_loss_matches_grafx_tpu(run):
    loss, ref = run["loss"], run["loss_j"]
    assert np.isfinite(loss) and run["total"] == loss  # no aux losses here
    assert db(np.float64(loss) - ref, np.float64(ref)) <= -60.0


def test_step_gradients_match_grafx_tpu(run):
    """float32: the concatenated gradient within -60 dB of grafx_tpu's,
    each leaf within grafx_tpu's own float32 spread + 6 dB of its float64
    gradient; float64: each leaf within GRAD_DB; leaves zero in JAX
    exactly zero in the port, absent gates' rows too; every smoothing
    coefficient of the composites has a gradient (the gate on -40 dB
    passages engages)."""
    got, ref, got64, ref64 = run["grads"], run["grads_j"], run["grads64"], run["grads_j64"]
    assert got.keys() == ref.keys() == got64.keys() == ref64.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert np.isfinite(cat(got)).all() and np.isfinite(cat(got64)).all()
    assert db(cat(got) - cat(ref), cat(ref)) <= -60.0
    for k in ref:
        if np.any(ref64[k] != 0):
            assert db(got64[k] - ref64[k], ref64[k]) <= GRAD_DB, (k, db(got64[k] - ref64[k], ref64[k]))
            spread = db(ref[k] - ref64[k], ref64[k])
            assert db(got[k] - ref64[k], ref64[k]) <= spread + 6.0, (k, db(got[k] - ref64[k], ref64[k]), spread)
        else:
            assert np.all(got[k] == 0) and np.all(got64[k] == 0), k
    for k, rows in run["absent"].items():
        assert np.all(got[k][rows] == 0), k
    for member in ("0_noisegate", "1_compressor"):
        for leaf in ("z_alpha_pre", "z_alpha_post"):
            assert np.any(got[f"{PAIR}/{member}/{leaf}"] != 0), (member, leaf)


def test_stream_matches_grafx_tpu(run):
    """The stream against grafx_tpu's StreamRenderer within -60 dB, and
    against the port's own one-shot render of that input, the request's
    first row (max abs over peak < 5e-4, as tests/test_torch_stream.py)."""
    got, ref = run["stream"], run["stream_j"]
    assert got.shape == ref.shape == (1, 2, L) and np.isfinite(got).all()
    assert db(got - ref, ref) <= -60.0, db(got - ref, ref)
    one_shot = run["render"][0]
    assert np.abs(got - one_shot).max() / np.abs(one_shot).max() < 5e-4


def test_request_step_and_block_run_the_walk(run):
    """On the CPU each wrapper runs its plain version.  A request runs the
    dynamics chain CHAIN_CALLS times (the composites, then the bus
    compressors), a step its forward with residuals and its adjoint
    CHAIN_CALLS times each, a block CHAIN_CALLS chains; no lone walk, fused gain or
    pair op runs anywhere."""
    calls = run["calls"]
    assert calls["request"] == {"ballistics_chain_plain": CHAIN_CALLS}
    assert calls["step"] == {"ballistics_chain_fwd_plain": CHAIN_CALLS, "ballistics_chain_bwd_plain": CHAIN_CALLS}
    assert calls["stream"] == {"ballistics_chain_plain": CHAIN_CALLS * (L // BLOCK)}
