"""The slice as a whole: the bench.py console with the filtered-noise
reverb and the piecewise tanh distortion (the noise console), and with
the feedback delay network and the Chebyshev distortion (the FDN
console), at 3 chains and L = 2^12 on the CPU: each fused render on a key
against grafx_tpu's render on the same key, the MSE step's loss and
gradients against jax.value_and_grad, and no warm path (keyed request,
step, keyed stream block) making a host tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from grafx_tpu import processors as jp
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch import random as tr
from grafx_tpu_torch.models import bench_console, bench_trainer
from grafx_tpu_torch.models.console import bench_processors
from grafx_tpu_torch.render import StreamRenderer, fuse_parameters, make_render_fn
from grafx_tpu_torch.utils import parameters_from_numpy, tree_items, tree_map
from test_torch_graph import FUSE, jax_processors
from test_torch_train import console_input, db

NUM_CHAINS, BATCH, L = 3, 2, 2**12
CONSOLES = {
    "noise": (lambda m: {"reverb": m.FilteredNoiseShapingReverb(),
                         "dist": m.PiecewiseTanhDistortion()}),
    "fdn": (lambda m: {"reverb": m.FeedbackDelayNetwork(), "dist": m.ChebyshevDistortion()}),
}


def port_processors(name):
    return {**bench_processors(), **CONSOLES[name](tp)}


def jax_console(name, params_j=None):
    """grafx_tpu's console ``name`` fused as bench.py fuses it, with its
    render closure and its parameters migrated."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
        Gj = bench.build_mix_graph()
    procs_j = {**jax_processors(), **CONSOLES[name](jp)}
    if params_j is None:
        params_j = j_create_params(procs_j, Gj, std=0.3, key=jax.random.PRNGKey(3))
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    render_j = j_make_render_fn(
        procs_j2, j_prepare(j_reorder(j_convert(Gj2), method="beam", use_native=False))
    )
    return render_j, params_j, params_j2


@pytest.fixture(scope="module", params=list(CONSOLES))
def console(request):
    """Both packages' console: the render on one key, and the keyless MSE
    step's loss and gradients (each package's first crop of its own
    instance's host draws)."""
    name = request.param
    render_j, params_j, params_j2 = jax_console(name)
    rng = np.random.default_rng(13)
    x = console_input(rng, (BATCH, NUM_CHAINS, 2, L))
    target = rng.standard_normal((BATCH, 1, 2, L)).astype(np.float32)
    jkey = jax.random.PRNGKey(2**31 + 9)
    y_j = np.asarray(render_j(x, params_j2, rng=jkey)[0])
    # a fresh instance for the step, so that its one trace draws the first crop
    step_j, _, params_j2 = jax_console(name, params_j)

    def loss_j(p):
        return jnp.mean((step_j(x, p)[0] - target) ** 2)

    value_j, grads_j = jax.jit(jax.value_and_grad(loss_j))(params_j2)

    c = bench_console(NUM_CHAINS, device="cpu", processors=port_processors(name))
    migrated = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    with torch.inference_mode():
        y = make_render_fn(c.fused_processors, c.plan)(
            torch.tensor(x), migrated, rng=tr.key_from_numpy(np.asarray(jkey)))[0].numpy()
    trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=port_processors(name))
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), trainer.params, migrated)
    total, audio = trainer.loss(torch.tensor(x), torch.tensor(target))
    total.backward()
    grads = tree_map(lambda p: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy(),
                     trainer.params)
    return dict(
        name=name, y=y, y_j=y_j, loss=audio.item(), loss_j=float(value_j),
        grads=dict(tree_items(grads)), grads_j=dict(tree_items(jax.tree.map(np.asarray, grads_j))),
    )


def test_console_render_on_a_key_matches_grafx_tpu(console):
    y, ref = console["y"], console["y_j"]
    assert y.shape == ref.shape == (BATCH, 1, 2, L)
    assert np.isfinite(y).all()
    assert db(y - ref, ref) <= -60.0, db(y - ref, ref)


def test_console_step_matches_grafx_tpu(console):
    """The MSE step's loss and concatenated gradient <= -60 dB against
    jax.value_and_grad, the reverb's and the distortion's leaves each <=
    -40 dB; leaves zero in JAX are zero in the port."""
    loss, ref = console["loss"], console["loss_j"]
    assert db(np.float64(loss) - ref, np.float64(ref)) <= -60.0
    got, want = console["grads"], console["grads_j"]
    assert got.keys() == want.keys()
    cat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert np.isfinite(cat(got)).all()
    assert db(cat(got) - cat(want), cat(want)) <= -60.0
    for k in want:
        if not np.any(want[k] != 0):
            assert np.all(got[k] == 0), k
        elif k.startswith(("reverb/", "dist/")):
            assert db(got[k] - want[k], want[k]) <= -40.0, (k, db(got[k] - want[k], want[k]))


@pytest.mark.parametrize("path", ["request", "step", "stream block"])
@pytest.mark.parametrize("name", list(CONSOLES))
def test_warm_keyed_path_makes_no_host_tensor(name, path):
    """A CUDA-graph capture refuses a tensor made from host data and a
    device value read on the host: no warm path of either console, the
    request and the stream on a key, does either."""
    from test_torch_compiled import HostOps

    rng = np.random.default_rng(6)
    x = torch.tensor(console_input(rng, (1, NUM_CHAINS, 2, L)))
    target = torch.tensor(rng.standard_normal((1, 1, 2, L)).astype(np.float32))
    key = tr.PRNGKey(4)
    if path == "step":
        trainer = bench_trainer(NUM_CHAINS, device="cpu", processors=port_processors(name))
        run = lambda: trainer.step(x, target)  # noqa: E731
    else:
        c = bench_console(NUM_CHAINS, device="cpu", processors=port_processors(name))
        if path == "request":
            render = make_render_fn(c.fused_processors, c.plan)
            run = lambda: render(x, c.params, rng=key)  # noqa: E731
        else:
            streamer = StreamRenderer(c.fused_processors, c.plan, c.params, block_len=1024, rng=key)
            state = streamer.init_state()
            run = lambda: streamer(x[0, ..., :1024], state)  # noqa: E731
    with torch.inference_mode(path == "request"):
        run()
        with HostOps() as ops:
            run()
    assert ops.seen == []
