"""grafx_tpu's public import surface resolves in grafx_tpu_torch: every
name of ``tests/test_api_surface.py:SURFACE`` under ``grafx_tpu`` ->
``grafx_tpu_torch``; the backend keywords the reference's constructors
take are taken here too (``inspect.signature`` of both packages), and
``FIRFilter`` builds with each."""

import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

from test_api_surface import SURFACE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# grafx_tpu/parallel/__init__.py's names
PARALLEL_NAMES = [
    "Mesh", "NamedSharding", "P", "batch_node_sharding", "batch_sharding", "make_mesh",
    "make_mesh_2d", "node_sharding", "replicated", "shard_render_step", "time_sharding",
]
PORT_SURFACE = {m.replace("grafx_tpu", "grafx_tpu_torch", 1): names for m, names in SURFACE.items()}

# (module under both packages, class): the keyword-only tail grafx_tpu takes
BACKEND_KEYWORDS = [
    ("processors", "Compressor"),
    ("processors", "NoiseGate"),
    ("processors", "FactorizedCompressor"),
    ("processors", "ApproxCompressor"),
    ("processors", "ApproxNoiseGate"),
    ("processors", "IIREnvelopeFollower"),
    ("processors", "STFTMaskedNoiseReverb"),
    ("processors", "FilteredNoiseShapingReverb"),
    ("processors", "FeedbackDelayNetwork"),
    ("processors", "FIRFilter"),
    ("processors.core", "TruncatedOnePoleIIRFilter"),
    ("processors.core", "FIRConvolution"),
    ("render", "render_grafx"),
    ("render", "make_render_fn"),
    ("render", "fuse_parameters"),
    ("render.order", "beam_search"),
    ("render.order", "fixed_order_search"),
    ("render.order", "one_by_one_search"),
    ("profiling", "time_fn"),
    ("data", "batch_grafx"),
]


@pytest.mark.parametrize("module", sorted(PORT_SURFACE))
def test_surface_resolves(module):
    m = importlib.import_module(module)
    missing = [n for n in PORT_SURFACE[module] if not hasattr(m, n)]
    assert not missing, f"{module} lacks {missing}"


def parameters(module, name):
    return [(p.name, p.kind, p.default) for p in inspect.signature(
        getattr(importlib.import_module(module), name)).parameters.values()]


@pytest.mark.parametrize("module,name", BACKEND_KEYWORDS)
def test_signature_matches_reference(module, name):
    """Names, kinds and defaults of every parameter equal grafx_tpu's,
    but the port's trailing additions (``render_grafx``'s
    ``return_buffer``)."""
    ref = parameters(f"grafx_tpu.{module}", name)
    got = parameters(f"grafx_tpu_torch.{module}", name)
    assert got[: len(ref)] == ref
    assert [p[0] for p in got[len(ref):]] in ([], ["return_buffer"])


@pytest.mark.parametrize("package", ["grafx_tpu", "grafx_tpu_torch"])
@pytest.mark.parametrize("kwargs", [{"overlap_save": True},
                                    {"flashfftconv": True, "max_input_len": 2**17}])
def test_fir_filter_takes_backend_keywords(package, kwargs):
    processors = importlib.import_module(f"{package}.processors")
    fir = processors.FIRFilter(**kwargs)
    assert fir.conv.overlap_save == kwargs.get("overlap_save", False)


@pytest.mark.parametrize("name,kwargs", [
    ("Compressor", {"energy_smoother": "iir", "flashfftconv": True}),
    ("NoiseGate", {"energy_smoother": "iir_exact", "max_input_len": 2**17}),
    ("FactorizedCompressor", {"iir_len": 4096, "flashfftconv": True}),
    ("ApproxCompressor", {"flashfftconv": True}),
    ("ApproxNoiseGate", {"flashfftconv": True}),
    ("IIREnvelopeFollower", {"flashfftconv": True}),
    ("STFTMaskedNoiseReverb", {"flashfftconv": True}),
    ("FilteredNoiseShapingReverb", {"flashfftconv": True}),
    ("FeedbackDelayNetwork", {"flashfftconv": True}),
])
def test_processors_take_backend_keywords(name, kwargs):
    for package in ("grafx_tpu", "grafx_tpu_torch"):
        getattr(importlib.import_module(f"{package}.processors"), name)(**kwargs)


def test_package_alone_exposes_the_subpackages():
    """``import grafx_tpu_torch`` alone, in a fresh interpreter, exposes
    the same subpackages under the same ``__all__`` as ``import
    grafx_tpu``, without importing jax or matplotlib (drawing imports it
    when it draws)."""
    code = ("import json, sys, grafx_tpu_torch as g; print(json.dumps([g.__all__,"
            " [n for n in g.__all__ if not hasattr(g, n)],"
            " sorted(m for m in ('jax', 'grafx_tpu', 'matplotlib') if m in sys.modules)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300)
    names, missing, imported = json.loads(out.stdout.splitlines()[-1])
    import grafx_tpu

    assert names == grafx_tpu.__all__
    assert not missing and not imported, (missing, imported)


def test_parallel_has_the_reference_names():
    jax_parallel = importlib.import_module("grafx_tpu.parallel")
    port = importlib.import_module("grafx_tpu_torch.parallel")
    assert sorted(jax_parallel.__all__) == PARALLEL_NAMES
    assert set(PARALLEL_NAMES) <= set(port.__all__)
    assert all(hasattr(port, n) for n in PARALLEL_NAMES)
