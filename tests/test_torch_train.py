"""The training slice as a whole: the bench.py gradient step (MSE on the
console fused with "pad-auto", parameters drawn on the unfused graph and
migrated) by grafx_tpu_torch against jax.value_and_grad of grafx_tpu's
fused render, at 6 chains, batch 2, L = 2^12.  Also the hand-written
adjoint of the exact IIR's state propagation and the losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.ops import iir as jiir
from grafx_tpu.ops import losses as jlosses
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.ops import iir, losses
from grafx_tpu_torch.render import fuse_parameters
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map
from test_torch_graph import FUSE, jax_processors

NUM_CHAINS, BATCH, L = 6, 2, 2**12
PLAIN_VERSIONS = tuple(
    f"{core}_plain" for core in (
        "ballistics_gain", "ballistics_gain_pair", "ballistics_gain_fwd", "ballistics_gain_bwd",
        "ballistics_gain_pair_fwd", "ballistics_gain_pair_bwd", "ballistics", "ballistics_fwd",
        "ballistics_bwd", "reverse_scan",
    )
)


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def console_input(rng, shape, block=512):
    """Noise with quiet passages (-40 dB blocks of ``block`` samples), so
    that the gates and the compressors' knees act and have gradients."""
    x = rng.standard_normal(shape)
    loud = rng.random(shape[:-2] + (1, shape[-1] // block)) < 0.5
    return (x * np.where(loud, 1.0, 0.01).repeat(block, axis=-1)).astype(np.float32)


def absent_rows(params):
    """``{leaf path: boolean rows of absent members}`` of fused composites."""
    rows = {}
    for t, sub in params.items():
        if isinstance(sub, dict) and "_absent" in sub:
            absent = np.asarray(sub["_absent"]) > 0.5
            for i, m in enumerate(sorted(k for k in sub if k != "_absent")):
                for path, _ in tree_items(sub[m], f"{t}/{m}/"):
                    rows[path] = absent[:, i]
    return rows


def count_calls(monkeypatch, module, names):
    """Count the calls of ``module.<name>`` for each name; returns the
    live ``{name: calls}`` dict."""
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        monkeypatch.setattr(module, name, counted(name, getattr(module, name)))
    return calls


def both_steps(procs_j, make_processors, key, seed):
    """The bench.py step at NUM_CHAINS x BATCH x L by both packages, from
    grafx_tpu's parameters drawn with ``key`` on the unfused graph and
    migrated to the port: the loss and gradients of jax.value_and_grad
    and of the port's trainer (``make_processors()`` for its console),
    with the plain versions the port's step called."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
        Gj = bench.build_mix_graph()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=key)
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    render_j = j_make_render_fn(
        procs_j2, j_prepare(j_reorder(j_convert(Gj2), method="beam", use_native=False))
    )
    rng = np.random.default_rng(seed)
    x = console_input(rng, (BATCH, NUM_CHAINS, 2, L))
    target = rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32)

    def loss_j(p):
        return jnp.mean((render_j(x, p)[0] - target) ** 2)

    value_j, grads_j = jax.value_and_grad(loss_j)(params_j2)  # eager: one call

    c = bench_console(NUM_CHAINS, device="cpu", processors=make_processors())
    migrated = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=make_processors())
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), trainer.params, migrated)
    bal.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        calls = count_calls(mp, bal, PLAIN_VERSIONS)
        total, audio = trainer.loss(torch.tensor(x), torch.tensor(target))
        total.backward()
    launches = bal.launch_counts()
    grads = tree_map(lambda p: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy(),
                     trainer.params)
    return dict(
        loss=audio.item(), loss_j=float(value_j), total=total.item(),
        grads=dict(tree_items(grads)),
        grads_j=dict(tree_items(jax.tree.map(np.asarray, grads_j))),
        absent=absent_rows(jax.tree.map(np.asarray, params_j2)),
        params=dict(tree_items(migrated)),
        params_j=dict(tree_items(jax.tree.map(np.asarray, params_j2))),
        launches=launches, calls=calls, trainer=trainer, console=c, x=x,
    )


@pytest.fixture(scope="module")
def step_grads():
    """Loss and gradients of the bench.py step from both packages."""
    return both_steps(jax_processors(), bench_processors, jax.random.PRNGKey(7), 21)


def test_step_loss_matches_grafx_tpu(step_grads):
    loss, ref = step_grads["loss"], step_grads["loss_j"]
    assert np.isfinite(loss) and step_grads["total"] == loss  # no aux losses here
    assert db(np.float64(loss) - ref, np.float64(ref)) <= -60.0


def test_step_gradients_match_grafx_tpu(step_grads):
    """Concatenated gradient <= -60 dB, each leaf whose JAX gradient is
    nonzero <= -40 dB, leaves zero in JAX exactly zero in the port."""
    got, ref = step_grads["grads"], step_grads["grads_j"]
    assert got.keys() == ref.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert np.isfinite(cat(got)).all()
    assert db(cat(got) - cat(ref), cat(ref)) <= -60.0
    for k in ref:
        if np.any(ref[k] != 0):
            assert db(got[k] - ref[k], ref[k]) <= -40.0, (k, db(got[k] - ref[k], ref[k]))
        else:
            assert np.all(got[k] == 0), k


def test_absent_members_get_no_gradient(step_grads):
    got, ref, absent = step_grads["grads"], step_grads["grads_j"], step_grads["absent"]
    assert absent and any(rows.any() for rows in absent.values())
    for k, rows in absent.items():
        assert np.all(got[k][rows] == 0) and np.all(ref[k][rows] == 0), k
        assert np.any(got[k][~rows] != 0) or np.all(ref[k][~rows] == 0), k
    assert all(np.all(v == 0) for k, v in got.items() if k.endswith("_absent"))


def test_step_runs_the_training_kernels(step_grads):
    """Every pair and bus call went through the Functions around #3-#6 (on
    the CPU, their plain versions): once forward and once backward per
    stage (one pair stage and one bus-compressor stage at 6 chains), the
    primal versions never, and nothing reached a kernel."""
    trainer = step_grads["trainer"]
    assert step_grads["launches"] == {name: 0 for name in step_grads["launches"]}
    assert step_grads["calls"] == {
        "ballistics_gain_fwd_plain": 1, "ballistics_gain_bwd_plain": 1,
        "ballistics_gain_pair_fwd_plain": 1, "ballistics_gain_pair_bwd_plain": 1,
    }
    assert not any(p.requires_grad for k, p in tree_items(trainer.params) if k.endswith("_absent"))


@pytest.mark.parametrize("num_blocks, S", [(1, 2), (7, 2), (32, 6)])
def test_propagate_states_adjoint_matches_jax(num_blocks, S):
    rng = np.random.default_rng(num_blocks)
    s_in = rng.standard_normal((3, num_blocks, S)).astype(np.float32)
    A = rng.standard_normal((3, S, S))
    # a stable transition (spectral radius 0.95), as a filter's is
    A = (0.95 * A / np.abs(np.linalg.eigvals(A)).max(-1)[:, None, None]).astype(np.float32)
    w = rng.standard_normal((3, num_blocks, S)).astype(np.float32)

    def f_j(s, a):
        return jnp.sum(jiir._propagate_states(s, a) * w)

    ref = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(s_in), jnp.asarray(A))
    s_t, A_t = torch.tensor(s_in, requires_grad=True), torch.tensor(A, requires_grad=True)
    out = iir._propagate_states(s_t, A_t)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jiir._propagate_states(s_in, A)), rtol=1e-5, atol=1e-5
    )
    (out * torch.tensor(w)).sum().backward()
    for g, r in zip((s_t.grad, A_t.grad), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


LOSSES = [
    ("stft_loss", {}),
    ("multi_resolution_stft_loss", {}),
    ("multi_resolution_stft_loss", {"n_ffts": (256, 512), "hop_ratio": 2}),
    ("mae_loss", {}),
    ("mse_loss", {}),
]


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name, kwargs", LOSSES)
def test_losses_match_jax(name, kwargs):
    """Values against grafx_tpu.ops.losses within rtol 1e-5, and their
    gradients: MAE / MSE within rtol 1e-5.  An STFT loss's float32
    gradient is ill-conditioned (its log-magnitude term scales by 1/|X|
    at near-empty bins): JAX's own is 1e-4 to 2e-3 (relative L2) from a
    float64 evaluation of the same loss, so the port's is held to within
    1e-5 plus twice that distance of JAX's."""
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, 1, 2, 8192)).astype(np.float32)
    y = rng.standard_normal((2, 1, 2, 8192)).astype(np.float32)
    fn_j, fn = getattr(jlosses, name), getattr(losses, name)
    value_j, grad_j = jax.value_and_grad(lambda a: fn_j(a, jnp.asarray(y), **kwargs))(jnp.asarray(x))
    grad_j = np.asarray(grad_j)
    xt = torch.tensor(x, requires_grad=True)
    value = fn(xt, torch.tensor(y), **kwargs)
    value.backward()
    np.testing.assert_allclose(value.item(), float(value_j), rtol=1e-5)
    if "stft" not in name:
        np.testing.assert_allclose(xt.grad.numpy(), grad_j, rtol=1e-5, atol=1e-7)
        return
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    fn(x64, torch.tensor(y, dtype=torch.float64), **kwargs).backward()
    assert rel(xt.grad.numpy(), grad_j) <= 1e-5 + 2 * rel(grad_j, x64.grad.numpy())


def test_precomputed_targets_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 2, 8192)).astype(np.float32)
    y = rng.standard_normal((2, 1, 2, 8192)).astype(np.float32)
    specs_j = jlosses.precompute_stft_targets(jnp.asarray(y))
    specs = losses.precompute_stft_targets(torch.tensor(y))
    for s, r in zip(specs, specs_j):
        np.testing.assert_allclose(s.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    value = losses.multi_resolution_stft_loss_precomputed(torch.tensor(x), specs)
    np.testing.assert_allclose(
        value.item(), float(jlosses.multi_resolution_stft_loss_precomputed(jnp.asarray(x), specs_j)),
        rtol=1e-5,
    )
    assert value.item() == losses.multi_resolution_stft_loss(torch.tensor(x), torch.tensor(y)).item()
    with pytest.raises(ValueError, match="same n_ffts"):
        losses.multi_resolution_stft_loss_precomputed(torch.tensor(x), specs[:2])
