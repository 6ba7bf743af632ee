"""GraphParameterOptimizer of grafx_tpu_torch: three SGD steps of the
bench.py console against grafx_tpu's optimizer with optax.sgd, and the
freezing, fusion and loss options on their own."""

import jax
import numpy as np
import optax
import pytest
import torch

import bench
from grafx_tpu.models.optimize import GraphParameterOptimizer as JOptimizer
from grafx_tpu.ops import losses as jlosses
from grafx_tpu_torch.models import GraphParameterOptimizer, bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_graph, bench_processors
from grafx_tpu_torch.ops import losses
from grafx_tpu_torch.utils import tree_items, tree_leaves, tree_map
from test_torch_graph import jax_processors
from test_torch_train import console_input

NUM_CHAINS, BATCH, L = 6, 2, 2**12


def test_sgd_trajectory_matches_grafx_tpu(monkeypatch):
    """bench_trainer against grafx_tpu's GraphParameterOptimizer with the
    same fusion, loss and optax.sgd(1e-3), from the same initial
    parameters: the loss history within rtol 1e-4."""
    monkeypatch.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
    opt_j = JOptimizer(
        bench.build_mix_graph(), jax_processors(), loss_fn=jlosses.mse_loss,
        optimizer=optax.sgd(1e-3), fuse="pad-auto", key=jax.random.PRNGKey(3),
    )
    trainer = bench_trainer(NUM_CHAINS, device="cpu")
    start = dict(tree_items(jax.tree.map(np.asarray, opt_j.params)))
    with torch.no_grad():
        for k, p in tree_items(trainer.params):
            p.copy_(torch.tensor(start[k]))
    rng = np.random.default_rng(5)
    x = console_input(rng, (BATCH, NUM_CHAINS, 2, L))
    target = rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32)

    history_j = opt_j.fit(x, target, num_steps=3)
    history = trainer.fit(torch.tensor(x), torch.tensor(target), num_steps=3)
    np.testing.assert_allclose(history, history_j, rtol=1e-4)
    assert history[2] < history[0]


def test_adam_leaves_frozen_and_absent_leaves_bitwise_unchanged():
    trainer = GraphParameterOptimizer(
        bench_graph(3), bench_processors(), loss_fn=losses.mse_loss,
        trainable={"gain": False, "reverb": False}, fuse="pad-auto", device="cpu",
    )
    assert isinstance(trainer.optimizer, torch.optim.Adam)
    before = {k: p.detach().clone() for k, p in tree_items(trainer.params)}
    rng = np.random.default_rng(1)
    x = torch.tensor(console_input(rng, (1, 3, 2, 2**11)))
    target = torch.tensor(rng.standard_normal((1, 1, 2, 2**11)).astype(np.float32))
    trainer.fit(x, target, num_steps=2)
    frozen = ("gain/", "reverb/", "_absent")
    moved = 0
    for k, p in tree_items(trainer.params):
        if k.startswith(frozen[:2]) or k.endswith(frozen[2]):
            assert not p.requires_grad and p.grad is None, k
            assert torch.equal(p, before[k]), k
        else:
            assert p.requires_grad, k
            if bool((p.grad != 0).any()):
                assert not torch.equal(p.detach(), before[k]), k
                moved += 1
    assert moved >= 10
    assert any(k.endswith("_absent") for k in before)


def test_trainable_tree_and_unknown_types():
    G, procs = bench_graph(2), bench_processors()
    with pytest.raises(ValueError, match="unknown processor types"):
        GraphParameterOptimizer(G, procs, trainable={"nope": False}, device="cpu")
    first = GraphParameterOptimizer(G, procs, fuse=True, device="cpu")
    spec = tree_map(lambda p: p.shape[-1] == 1, first.params)
    trainer = GraphParameterOptimizer(G, procs, trainable=spec, fuse=True, device="cpu")
    for (k, p), (_, m) in zip(tree_items(trainer.params), tree_items(spec)):
        assert p.requires_grad == (m and not k.endswith("_absent")), k
    assert sum(p.numel() for p in trainer.optimizer.param_groups[0]["params"]) == sum(
        p.numel() for p in tree_leaves(trainer.params) if p.requires_grad
    )


@pytest.mark.parametrize("fuse", [False, True, "pad", "pad-auto"])
def test_fuse_options_draw_parameters_on_the_unfused_graph(fuse):
    """Every fuse option renders the same console from the same draw; the
    padded members start absent."""
    G, procs = bench_graph(4), bench_processors()
    trainer = GraphParameterOptimizer(
        G, procs, fuse=fuse, generator=torch.Generator().manual_seed(2), device="cpu"
    )
    x = torch.tensor(console_input(np.random.default_rng(0), (1, 4, 2, 2**11)))
    y = trainer.render_current(x)
    assert not y.requires_grad
    ref = GraphParameterOptimizer(
        G, procs, generator=torch.Generator().manual_seed(2), device="cpu"
    )
    np.testing.assert_allclose(y.numpy(), ref.render_current(x).numpy(), rtol=1e-4, atol=1e-6)
    if fuse in ("pad", "pad-auto"):
        absent = [p for k, p in tree_items(trainer.params) if k.endswith("_absent")]
        assert absent and all(bool((a > 0.5).any()) for a in absent)


def test_default_loss_caches_the_target_spectrograms():
    trainer = GraphParameterOptimizer(
        bench_graph(2), bench_processors(), fuse="pad-auto", device="cpu"
    )
    rng = np.random.default_rng(2)
    x = torch.tensor(console_input(rng, (1, 2, 2, 2**12)))
    target = torch.tensor(rng.standard_normal((1, 1, 2, 2**12)).astype(np.float32))
    total, audio = trainer.loss(x, target)
    specs = trainer._target_cache[1]
    assert trainer._target_cache[0] is target and len(specs) == 3
    expected = losses.multi_resolution_stft_loss(trainer.render_current(x), target)
    assert total.item() == audio.item() == pytest.approx(expected.item(), rel=1e-6)
    trainer.step(x, target)
    assert trainer._target_cache[1] is specs


def test_bench_trainer_starts_from_the_serving_parameters():
    trainer = bench_trainer(3, seed=4, device="cpu")
    console = bench_console(3, seed=4, device="cpu")
    got, ref = dict(tree_items(trainer.params)), dict(tree_items(console.params))
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k].detach(), ref[k]), k
    assert isinstance(trainer.optimizer, torch.optim.SGD)
    assert trainer.optimizer.param_groups[0]["lr"] == 1e-3


@pytest.mark.parametrize(
    "entry_point",
    [
        lambda: bench_console(2),
        lambda: bench_trainer(2),
        lambda: GraphParameterOptimizer(bench_graph(2), bench_processors()),
    ],
)
def test_entry_points_default_to_the_card(entry_point, monkeypatch):
    """Without ``device`` the entry points ask for the card and raise where
    torch sees none, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_point()
