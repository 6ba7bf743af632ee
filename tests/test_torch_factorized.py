"""The factorized slice as a whole: the bench.py console with
FactorizedCompressor(frame_len) as its compressor, its gradient step
(MSE on the console fused with "pad-auto", parameters drawn on the
unfused graph and migrated) by grafx_tpu_torch against
jax.value_and_grad of grafx_tpu's fused render, at 6 chains, batch 2,
L = 2^12 and frame_len = 256; and the plain versions each step and each
request calls."""

import jax
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.render import make_render_fn
from grafx_tpu_torch.utils import tree_items
from test_torch_graph import jax_processors
from test_torch_train import BATCH, L, PLAIN_VERSIONS, both_steps, count_calls, db

FRAME = 256


def factorized_processors():
    return {**bench_processors(), "compressor": tp.FactorizedCompressor(frame_len=FRAME)}


@pytest.fixture(scope="module")
def slice_run():
    """Loss and gradients of the factorized step from both packages, and
    the plain versions one step and one served request call."""
    procs_j = {**jax_processors(), "compressor": jp.FactorizedCompressor(frame_len=FRAME)}
    run = both_steps(procs_j, factorized_processors, jax.random.PRNGKey(11), 23)
    c, trainer, x = run["console"], run["trainer"], torch.tensor(run["x"])
    with pytest.MonkeyPatch.context() as mp:
        run["request_calls"] = count_calls(mp, bal, PLAIN_VERSIONS)
        with torch.inference_mode():
            y = make_render_fn(c.fused_processors, c.plan)(x, trainer.params)[0]
    run["render"] = y.numpy()
    run["render_train"] = trainer.render(x, trainer.params)[0].detach().numpy()
    return run


def test_factorized_parameters_migrate_unchanged(slice_run):
    """FactorizedCompressor's parameters are the ballistics Compressor's,
    so grafx_tpu's parameters carry across parameters_from_numpy and
    fuse_parameters as they are, on the console fused as grafx_tpu fuses
    it: the gate chains' fused(noisegate+compressor) and the bus
    compressors alone."""
    got, ref = slice_run["params"], slice_run["params_j"]
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    procs = slice_run["console"].fused_processors
    assert isinstance(procs["compressor"], tp.FactorizedCompressor)
    assert isinstance(procs["fused(noisegate+compressor)"].members[1][1], tp.FactorizedCompressor)
    assert (
        tp.FactorizedCompressor().parameter_size()
        == tp.Compressor(energy_smoother="ballistics").parameter_size()
    )


def test_factorized_request_equals_the_training_forward(slice_run):
    """The served render (primal walks, no grad) is the trainer's forward
    (walks with residuals) bit for bit: the same walk either way."""
    got = slice_run["render"]
    assert np.isfinite(got).all() and got.shape == (BATCH, 1, 2, L)
    np.testing.assert_array_equal(got, slice_run["render_train"])


def test_factorized_step_loss_matches_grafx_tpu(slice_run):
    loss, ref = slice_run["loss"], slice_run["loss_j"]
    assert np.isfinite(loss) and slice_run["total"] == loss  # no aux losses here
    assert db(np.float64(loss) - ref, np.float64(ref)) <= -60.0


def test_factorized_step_gradients_match_grafx_tpu(slice_run):
    """Concatenated gradient <= -60 dB, each leaf whose JAX gradient is
    nonzero <= -40 dB, leaves zero in JAX exactly zero in the port; the
    compressors' smoothing coefficients (the frame walks' adjoint) have
    gradients in both fused types."""
    got, ref = slice_run["grads"], slice_run["grads_j"]
    assert got.keys() == ref.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert np.isfinite(cat(got)).all()
    assert db(cat(got) - cat(ref), cat(ref)) <= -60.0
    for k in ref:
        if np.any(ref[k] != 0):
            assert db(got[k] - ref[k], ref[k]) <= -40.0, (k, db(got[k] - ref[k], ref[k]))
        else:
            assert np.all(got[k] == 0), k
    for k in ("compressor/z_alpha_pre", "fused(noisegate+compressor)/1_compressor/z_alpha_pre"):
        assert np.any(got[k] != 0) and np.any(ref[k] != 0), k


def test_factorized_absent_gates_get_no_gradient(slice_run):
    got, absent = slice_run["grads"], slice_run["absent"]
    assert absent and any(rows.any() for rows in absent.values())
    for k, rows in absent.items():
        assert np.all(got[k][rows] == 0), k
    assert all(np.all(v == 0) for k, v in got.items() if k.endswith("_absent"))
    trainer = slice_run["trainer"]
    assert not any(p.requires_grad for k, p in tree_items(trainer.params) if k.endswith("_absent"))


def test_factorized_step_and_request_run_their_plain_versions(slice_run):
    """On the CPU each wrapper runs its plain version and launches
    nothing.  A step: the gate member's fused gain forward and adjoint
    (#5/#6) once, the frame walk with residuals and its adjoint (#8/#9)
    twice (the chains' and the bus compressors'), nothing else.  A
    request: the gate's primal gain (#2) once and the primal frame walk
    (#7) twice (the plain primal gain is the plain forward with
    residuals, cut to the gain)."""
    assert slice_run["launches"] == {name: 0 for name in slice_run["launches"]}
    assert slice_run["calls"] == {
        "ballistics_gain_fwd_plain": 1, "ballistics_gain_bwd_plain": 1,
        "ballistics_fwd_plain": 2, "ballistics_bwd_plain": 2,
    }
    assert slice_run["request_calls"] == {
        "ballistics_gain_plain": 1, "ballistics_gain_fwd_plain": 1, "ballistics_plain": 2,
    }
