"""The frame-factorized console of the benchmark (``portbench``'s
``console17_fact``) on the CPU: its reference module
(``portbench/reference/FactorizedCompressor.py``) against the port's
``FactorizedCompressor``, the module's refusals and counts, the
configuration against ``console17_exact``'s and ``bench_graph(17)``, and
the reference graph against the port's fused trainer at a small size.

The module against the port: 6 rows of noise with -40 dB passages, at
4096 samples (4 whole frames of 1024) and at 4096 + 300 (a last frame of
300 samples, zero-padded), in float64, the render and the gradient of
every leaf under a cotangent that weighs every sample differently.  Two
draws: the port's (N(0, 0.01^2): coefficients near 0.5, and every
envelope above the knee, so that ``log_knee``'s gradient is exactly 0 on
both sides), and a slow one (``z_alpha_pre`` near -4, about 0.02, with
the threshold and the knee moved into the envelope's range, so that the
knee's middle acts and every leaf has a gradient).

Tolerances.  Both sides compute in float64 and hold the walk's
attack/release decisions constant under the gradient; they round apart
only where the port picks the lerp's weights by offset and the module
gathers the two neighbouring frames.  The widest gaps, relative to the
largest value, were 5.1e-16 in the render and 1.5e-15 in a leaf's
gradient.  RTOL_Y = 1e-10 and RTOL_G = 1e-8 leave five decades of room
and stay far below what float32 gives (the port in float32: 4.7e-7 in
the render, 3.2e-4 to 4.2e-4 in the gradients), so a step computed in
float32, a missing term, a nearest-frame upsample (3.8e-3 to 9.2e-2 in
the render) or a walk started from 0 (0.66 to 1.09) fails them.
"""

import json
import os
import time

import pytest
import torch

from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.utils import create_empty_parameters_from_shape_dict
from portbench import harness, traffic
from portbench.reference import Compressor, FactorizedCompressor, graph

ROOT = os.path.dirname(harness.HERE)
ROWS, LENGTHS = 6, (4096, 4096 + 300)
RTOL_Y, RTOL_G = 1e-10, 1e-8
STEMS = {"kind": "quiet_passages", "blocks": 36, "quiet_db": -40.0, "loud_share": 0.5}
SPEC = {"class": "FactorizedCompressor", "args": {"frame_len": 1024}}
CELL = "console17_fact.train"
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def draw(proc, slow):
    g = torch.Generator().manual_seed(2**31 + 5)
    p = create_empty_parameters_from_shape_dict(proc.parameter_size(), ROWS, g, root=False,
                                                dtype=torch.float64)
    if slow:
        for name, centre in (("z_alpha_pre", -4.0), ("log_threshold", 5.0), ("log_knee", 1.0)):
            p[name] = centre + 0.5 * torch.randn(p[name].shape, generator=g, dtype=torch.float64)
    return p


def signal(length):
    """Noise with -40 dB passages of 128 samples, cut to ``length``."""
    g = torch.Generator().manual_seed(2**31 + 3)
    return traffic.stems(STEMS, (ROWS, 2, 36 * 128), g, "cpu").double()[..., :length]


def render_and_grads(fn, x, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    y = fn(x, leaves)
    w = torch.cos(torch.arange(y.numel(), dtype=y.dtype) * 0.37).reshape(y.shape)
    grads = torch.autograd.grad(torch.sum(w * y), list(leaves.values()))
    return y.detach(), dict(zip(leaves, grads))


def reference(x, p):
    return FactorizedCompressor.render(x, p, SPEC["args"], None)


def port_and_reference(length, slow):
    proc = tp.FactorizedCompressor(**SPEC["args"])
    x, params = signal(length), draw(proc, slow)
    port = render_and_grads(lambda s, p: proc(s, **p), x, params)
    return port, render_and_grads(reference, x, params), x


def assert_agree(port, ref):
    (y, grads), (y_ref, grads_ref) = port, ref
    torch.testing.assert_close(y, y_ref, rtol=RTOL_Y, atol=RTOL_Y * float(y_ref.abs().max()))
    assert set(grads) == set(grads_ref)
    for name, g_ref in grads_ref.items():
        torch.testing.assert_close(grads[name], g_ref, rtol=RTOL_G,
                                   atol=RTOL_G * float(g_ref.abs().max()), msg=name)


@pytest.mark.parametrize("slow", [False, True], ids=["default_draw", "slow_draw"])
@pytest.mark.parametrize("length", LENGTHS)
def test_reference_matches_the_port(length, slow):
    proc = tp.FactorizedCompressor(**SPEC["args"])
    assert proc.gain_op == ("frame", (("compressor", None),))  # the frame gain op
    assert {k: tuple(v) if isinstance(v, tuple) else (v,) for k, v in proc.parameter_size().items()} \
        == FactorizedCompressor.parameter_size(SPEC["args"])
    port, ref, x = port_and_reference(length, slow)
    # the compressor acts on every sample
    assert torch.mean((torch.abs(ref[0] / x - 1.0) > 1e-3).double()) > 0.9
    for name, g in ref[1].items():
        assert float(g.abs().max()) > 0 or (name == "log_knee" and not slow), name
    assert_agree(port, ref)


def nearest_frame(s, length):
    """Each sample takes its own frame's value: no interpolation."""
    return s[:, torch.arange(length) // FactorizedCompressor.FRAME_LEN]


@pytest.mark.parametrize("slow", [False, True], ids=["default_draw", "slow_draw"])
@pytest.mark.parametrize("broken", ["nearest_frame_upsample", "walk_from_zero"])
def test_a_broken_reference_fails_the_tolerances(broken, slow, monkeypatch):
    port, _, x = port_and_reference(LENGTHS[1], slow)
    if broken == "nearest_frame_upsample":
        monkeypatch.setattr(FactorizedCompressor, "upsample", nearest_frame)
    else:
        monkeypatch.setattr(FactorizedCompressor, "INIT", 0.0)
    params = draw(tp.FactorizedCompressor(**SPEC["args"]), slow)
    with pytest.raises(AssertionError):
        assert_agree(port, render_and_grads(reference, x, params))


@pytest.mark.parametrize("args", [
    {"frame_len": 512},
    {"frame_len": 1024, "gain_smoother": "ballistics"},
    {"frame_len": 1024, "knee": "hard"},
    {"frame_len": 1024, "knee": "exponential"},
    {"frame_len": 1024, "iir_len": 4096},
], ids=["frame_len", "gain_smoother", "hard_knee", "exponential_knee", "other_argument"])
def test_reference_refuses_other_arguments(args):
    with pytest.raises(NotImplementedError):
        FactorizedCompressor.parameter_size(args)
    x = torch.ones(1, 2, 64, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        FactorizedCompressor.render(x, {}, args, None)


def load_config(name):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


with open(os.path.join(harness.HERE, "tests", "console3.json")) as f:
    SMALL = json.load(f)  # console3's graph and size


def small(name):
    return {**load_config(name), **SMALL}


@pytest.mark.parametrize("train", [False, True])
def test_counts_walk_the_compressors_at_frame_rate(train):
    """On the 3-chain console (1 gate, 5 compressors) the factorized
    configuration counts each compressor's walk on frames: its walk bytes
    are the plain walk's at frame rate, and its operations a sample the
    plain compressor's less the walk's 4, plus the pooling's 1 and the
    lerp's 3, with the walk's 4 a frame."""
    B, L = 3, 2**12 + 300
    frames = -(-L // 1024)
    exact, fact = (graph.count(small(n), B, L, train) for n in ("console17_exact", "console17_fact"))
    per_node = B * L * (FactorizedCompressor.FLOPS_PER_SAMPLE - Compressor.FLOPS_PER_SAMPLE) \
        + B * frames * FactorizedCompressor.FLOPS_PER_FRAME
    assert fact[0] - exact[0] == 5 * per_node * (3 if train else 1)
    per = 5 if train else 2
    assert exact[1] - fact[1] == 5 * 4 * B * (L - frames) * per
    assert fact[1] == 4 * B * L * per + 5 * 4 * B * frames * per


def test_config_is_exact_with_the_factorized_compressor():
    """``console17_fact`` is ``console17_exact`` with the compressor
    entry swapped, its name, source and one more assumption; nothing is
    cut."""
    exact, fact = load_config("console17_exact"), load_config("console17_fact")
    assert fact["processors"] == {**exact["processors"], "compressor": SPEC}
    assert fact["assumed"] == {**exact["assumed"], "frame_len": fact["assumed"]["frame_len"]}
    same = set(exact) - {"name", "source", "assumed", "processors"}
    assert set(fact) == set(exact) and {k: fact[k] for k in same} == {k: exact[k] for k in same}
    assert fact["name"] == "console17_fact" and fact["reduced"] == []
    (entry,) = [c for c in BENCH["configs"] if c["name"] == "console17_fact"]
    assert entry["file"] == "portbench/configs/console17_fact.json" and entry["reduced"] == []
    (cell,) = [w for w in BENCH["workloads"] if w["config"] == "console17_fact"]
    assert cell["name"] == CELL and cell["traffic"] == "train" and cell["chips"] == 1


def test_config_graph_is_the_bench_console():
    from grafx_tpu_torch.models.console import bench_graph, bench_processors

    cfg = load_config("console17_fact")
    G = bench_graph(17)
    assert cfg["nodes"] == [G.nodes[n]["node_type"] for n in sorted(G.nodes)]
    assert sorted(map(tuple, cfg["edges"])) == sorted(G.edges())
    procs = bench_processors(cfg["processors"]["eq"]["args"]["backend"])
    for t, p in cfg["processors"].items():
        want = "FactorizedCompressor" if t == "compressor" else type(procs[t]).__name__
        assert p["class"] == want, t


# the small size's own limits, as portbench/tests' (the port reads 7.6e-8,
# 6.0e-6 and 9.9e-3 here; the last, the reverb's change, is float32's: the
# reference as the TF32 control reads it too, and the half-batch fault 8.6e-2)
SMALL_LIMITS = {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 2e-3},
                "change_gap": {"limit": 2e-2}}


def small_run(fault=None):
    return harness.run_cell(BENCH, CELL, 2**31 + 11, 0.2, False, "cpu", time.perf_counter(),
                            overrides=SMALL, fault=fault, limits=SMALL_LIMITS)


def test_reference_graph_agrees_with_the_fused_trainer():
    """The cell's run at console3's size on the CPU: the port's
    ``GraphParameterOptimizer`` (pad-auto, the factorized compressors in
    the composed dynamics runs) against the reference graph, over the
    first two steps' losses, first gradient and change, with the frame
    walk's coefficients among the leaves compared."""
    result, lines, run = small_run()
    assert result["correct"], lines
    assert set(result["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    leaves = run.notes["leaves"]
    for gap in ("grad_gap", "change_gap"):
        assert "compressor/z_alpha_pre" in leaves[gap], gap


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_trainer_is_not_correct(fault):
    result, lines, _ = small_run(fault)
    assert not result["correct"], lines
