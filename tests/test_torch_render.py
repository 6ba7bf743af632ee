"""The serving slice as a whole: the bench.py console (6 chains, batch 2,
L = 2^12) rendered by grafx_tpu_torch against grafx_tpu."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
from grafx_tpu.data import convert_to_tensor as j_convert
from grafx_tpu.render import fuse_parameters as j_fuse_parameters
from grafx_tpu.render import fuse_serial_lti as j_fuse
from grafx_tpu.render import make_render_fn as j_make_render_fn
from grafx_tpu.render import prepare_render as j_prepare
from grafx_tpu.render import reorder_for_fast_render as j_reorder
from grafx_tpu.utils import create_empty_parameters as j_create_params
from grafx_tpu_torch.models import bench_console
from grafx_tpu_torch.render import fuse_parameters, make_render_fn
from grafx_tpu_torch.utils import parameters_from_numpy
from test_torch_graph import FUSE, jax_processors

NUM_CHAINS, BATCH, L = 6, 2, 2**12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def jax_render(G, processors, params, x):
    plan = j_prepare(j_reorder(j_convert(G), method="beam", use_native=False))
    return np.asarray(j_make_render_fn(processors, plan)(x, params)[0])


@pytest.fixture(scope="module")
def slice_outputs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "NUM_CHAINS", NUM_CHAINS)
        Gj = bench.build_mix_graph()
    procs_j = jax_processors()
    params_j = j_create_params(procs_j, Gj, std=0.1, key=jax.random.PRNGKey(7))
    x = np.random.default_rng(11).standard_normal((BATCH, NUM_CHAINS, 2, L)).astype(np.float32)

    y_unfused = jax_render(Gj, procs_j, params_j, x)
    Gj2, procs_j2 = j_fuse(Gj, procs_j, **FUSE)
    params_j2 = j_fuse_parameters(params_j, Gj, Gj2, procs_j2, use_native=False)
    y_fused = jax_render(Gj2, procs_j2, params_j2, x)

    c = bench_console(NUM_CHAINS, device="cpu")
    params = fuse_parameters(
        parameters_from_numpy(jax.tree.map(np.asarray, params_j)),
        c.graph, c.fused_graph, c.fused_processors,
    )
    with torch.inference_mode():
        y, _, buf = make_render_fn(c.fused_processors, c.plan)(
            torch.tensor(x), params, return_buffer=True
        )
    return dict(y=y.numpy(), buf=buf.numpy(), unfused=y_unfused, fused=y_fused, plan=c.plan)


@pytest.mark.parametrize("reference", ["unfused", "fused"])
def test_slice_matches_grafx_tpu(slice_outputs, reference):
    """The port's fused render against grafx_tpu's unfused render with the
    unfused parameters, and against its fused render (composed dynamics
    on the CPU) with the migrated parameters: within -60 dB."""
    y, ref = slice_outputs["y"], slice_outputs[reference]
    assert y.shape == ref.shape == (BATCH, 1, 2, L)
    assert np.isfinite(y).all()
    assert db(y - ref, ref) <= -60.0, db(y - ref, ref)


def test_signal_buffer_only_on_request(slice_outputs):
    plan = slice_outputs["plan"]
    buf = slice_outputs["buf"]
    assert buf.shape == (BATCH, plan.num_buffers, 2, L)
    np.testing.assert_array_equal(buf[:, -1:], slice_outputs["y"])
    c = bench_console(2, device="cpu")
    x = torch.zeros(1, 2, 2, 256)
    with torch.inference_mode():
        assert make_render_fn(c.fused_processors, c.plan)(x, c.params)[2] is None


def test_import_leaves_jax_and_networkx_out():
    """Every module of the package imports without jax, networkx or
    grafx_tpu (and the drawing modules without matplotlib, which they
    import when they draw), and so does a native schedule of a graph."""
    code = (
        "import pkgutil, sys, grafx_tpu_torch\n"
        "for m in pkgutil.walk_packages(grafx_tpu_torch.__path__, 'grafx_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "new = ('serving', 'profiling', '_native', 'data.batch', 'draw.graph', 'draw.position')\n"
        "assert all('grafx_tpu_torch.' + m in sys.modules for m in new)\n"
        "from grafx_tpu_torch.models.console import bench_graph\n"
        "from grafx_tpu_torch.render import reorder_for_fast_render\n"
        "reorder_for_fast_render(bench_graph(3), method='one-by-one')\n"
        "bad = [m for m in ('jax', 'networkx', 'grafx_tpu', 'matplotlib') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
