"""The gain-smoothed compressor's and gate's reference modules
(``reference/GainSmoothedCompressor.py``, ``GainSmoothedNoiseGate.py``)
against the port's processors, on the CPU in float64: 6 rows x 4096
samples of noise with -40 dB passages (so that the knees and the gate
act), the render and the gradient of every leaf, ``z_alpha_post`` among
them, at the port's default draw (N(0, 0.01^2): coefficients near 0.5)
and at a seeded draw of slow coefficients (``z_alpha_*`` near -4, about
0.02), where the attack and release decisions matter; each module's
refusal of other arguments; and the operations the gain walks add to the
yardstick's count.

Tolerances.  Both sides compute in float64 and hold the attack/release
decisions constant under the gradient; they differ in how they round:
the port walks in links of 8 samples (a max of affine pieces), the
reference sample by sample, and the reference runs the gate's one-pole
by FFT (its aliasing under exp(-45)).  Over 4096 samples the widest
gaps, relative to the largest value, were 1.8e-13 in the render and
6.7e-12 in a leaf's gradient (the gate's ``z_alpha_pre``, through the
one-pole); RTOL_Y = 1e-10 and RTOL_G = 1e-8 leave two or more decades
of room and stay far below float32's 1e-7, so a step computed in
float32 anywhere, or a missing term, fails them (a gain walk started
from 0 fails both draws of its module).
"""

import json
import os

import pytest
import torch

from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.utils import create_empty_parameters_from_shape_dict
from portbench import harness, traffic
from portbench.reference import GainSmoothedCompressor, GainSmoothedNoiseGate, graph

ROWS, LENGTH = 6, 4096
RTOL_Y, RTOL_G = 1e-10, 1e-8
STEMS = {"kind": "quiet_passages", "blocks": 32, "quiet_db": -40.0, "loud_share": 0.5}
SPECS = {
    "compressor": {"class": "Compressor", "reference": "GainSmoothedCompressor",
                   "args": {"energy_smoother": "ballistics", "gain_smoother": "ballistics"}},
    "noisegate": {"class": "NoiseGate", "reference": "GainSmoothedNoiseGate",
                  "args": {"energy_smoother": "iir_exact", "gain_smoother": "ballistics",
                           "gain_smooth_in_log": True}},
}


def draw(proc, slow):
    g = torch.Generator().manual_seed(2**31 + 5)
    p = create_empty_parameters_from_shape_dict(proc.parameter_size(), ROWS, g, root=False,
                                                dtype=torch.float64)
    if slow:
        for name in ("z_alpha_pre", "z_alpha_post"):
            p[name] = -4.0 + 0.5 * torch.randn(p[name].shape, generator=g, dtype=torch.float64)
    return p


def signal():
    g = torch.Generator().manual_seed(2**31 + 3)
    return traffic.stems(STEMS, (ROWS, 2, LENGTH), g, "cpu").double()


def render_and_grads(fn, x, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    y = fn(x, leaves)
    # a cotangent that weighs every sample differently
    w = torch.cos(torch.arange(y.numel(), dtype=y.dtype) * 0.37).reshape(y.shape)
    grads = torch.autograd.grad(torch.sum(w * y), list(leaves.values()))
    return y.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("slow", [False, True], ids=["default_draw", "slow_draw"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_reference_matches_the_port(kind, slow):
    spec = SPECS[kind]
    proc = getattr(tp, spec["class"])(**spec["args"])
    assert proc.chain_spec is not None  # the port runs it as the dynamics chain
    ref = graph.module(spec)
    assert {k: tuple(v) if isinstance(v, tuple) else (v,) for k, v in proc.parameter_size().items()} \
        == ref.parameter_size(spec["args"])
    x, params = signal(), draw(proc, slow)
    y, grads = render_and_grads(lambda s, p: proc(s, **p), x, params)
    y_ref, grads_ref = render_and_grads(lambda s, p: ref.render(s, p, spec["args"], None), x, params)
    # the knee and the gate act: the gain departs from 1 on many samples
    assert torch.mean((torch.abs(y_ref / x - 1.0) > 1e-3).double()) > 0.1
    torch.testing.assert_close(y, y_ref, rtol=RTOL_Y, atol=RTOL_Y * float(y_ref.abs().max()))
    assert set(grads) == set(grads_ref) >= {"z_alpha_pre", "z_alpha_post"}
    for name, g_ref in grads_ref.items():
        assert float(g_ref.abs().max()) > 0, name
        torch.testing.assert_close(grads[name], g_ref, rtol=RTOL_G,
                                   atol=RTOL_G * float(g_ref.abs().max()), msg=name)


@pytest.mark.parametrize("module,args", [
    (GainSmoothedCompressor, {"energy_smoother": "ballistics"}),
    (GainSmoothedCompressor, {"energy_smoother": "ballistics", "gain_smoother": "ballistics",
                              "gain_smooth_in_log": True}),
    (GainSmoothedCompressor, {"energy_smoother": "ballistics", "gain_smoother": "ballistics",
                              "knee": "hard"}),
    (GainSmoothedNoiseGate, {"energy_smoother": "iir_exact", "gain_smoother": "ballistics"}),
    (GainSmoothedNoiseGate, {"energy_smoother": "iir_exact", "gain_smoother": "ballistics",
                             "gain_smooth_in_log": True, "iir_len": 4096}),
])
def test_reference_refuses_other_arguments(module, args):
    with pytest.raises(NotImplementedError):
        module.parameter_size(args)


@pytest.mark.parametrize("train", [False, True])
def test_counts_add_the_gain_walks(train):
    """On the 3-chain console (1 gate, 5 compressors) the gain-smoothed
    configuration counts 4 operations a sample more for each dynamics
    node than the exact one (three times that for a step), and the same
    walk bytes."""
    B, L = 3, 2**12
    with open(os.path.join(os.path.dirname(__file__), "console3.json")) as f:
        small = json.load(f)
    counts = {}
    for name in ("exact", "gs"):
        with open(os.path.join(harness.HERE, "configs", f"console17_{name}.json")) as f:
            counts[name] = graph.count({**json.load(f), **small}, B, L, train)
    walks = 6 * 4 * B * L * (3 if train else 1)
    assert counts["gs"][0] - counts["exact"][0] == walks
    assert counts["gs"][1] == counts["exact"][1] == 6 * 4 * B * L * (5 if train else 2)
