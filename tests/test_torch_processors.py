"""Every processor of the serving slice against its grafx_tpu counterpart
on the same inputs and parameters (numpy arrays handed to both)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grafx_tpu.ops.ballistics_tpu as jtpu
from grafx_tpu import processors as jp
from grafx_tpu.render import fuse as jfuse
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.render import fuse as tfuse

L = 2**12


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def random_params(sizes, N, rng, std=0.5):
    out = {}
    for k, v in sizes.items():
        if isinstance(v, dict):
            out[k] = random_params(v, N, rng, std)
        else:
            shape = (N,) + (v if isinstance(v, tuple) else (v,))
            out[k] = (std * rng.standard_normal(shape)).astype(np.float32)
    return out


def to_jax(tree):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


def run_both(jproc, tproc, params, N=3, C=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, L)).astype(np.float32)
    p = random_params(tproc.parameter_size(), N, rng) if params is None else params
    assert jproc.parameter_size() == tproc.parameter_size()
    ref = np.asarray(jax.jit(lambda x, p: jproc(x, **p))(jnp.asarray(x), to_jax(p)))
    got = tproc(torch.tensor(x), **to_torch(p)).numpy()
    assert got.shape == ref.shape
    return got, ref


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route grafx_tpu's fused gain path through its Pallas kernels in
    interpret mode (on the CPU it would otherwise compose the smoother
    and the knee in plain JAX)."""
    monkeypatch.setattr("grafx_tpu.ops.ballistics.fused_gain_available", lambda: True)
    monkeypatch.setattr("grafx_tpu.processors.dynamics.fused_gain_available", lambda: True)
    for name in ("forward_gain_only_pallas_tm", "forward_gain_pair_pallas_tm"):
        monkeypatch.setattr(
            jtpu, name, functools.partial(getattr(jtpu, name), interpret=True)
        )


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.ParametricEqualizer(num_filters=6, backend="exact"),
        lambda m: m.ParametricEqualizer(
            num_filters=4, backend="exact", processor_channel="midside",
            use_shelving_filters=False,
        ),
        lambda m: m.GraphicEqualizer(scale="bark", backend="exact"),
        lambda m: m.GraphicEqualizer(scale="third_octave", backend="exact", processor_channel="stereo"),
    ],
)
def test_equalizers_match(make):
    got, ref = run_both(make(jp), make(tp), None)
    # the bound tests/ops/test_iir.py holds real EQ cascades to (1e-3):
    # low bands sit near the unit circle, where float32 itself is ~6e-4
    # from scipy float64 (third-octave, 19.7 Hz band)
    assert max_rel(got, ref) < 1e-3


@pytest.mark.parametrize(
    "cls, smoother, knee, jax_path",
    [
        ("Compressor", "ballistics", "quadratic", "composed"),
        ("Compressor", "ballistics", "quadratic", "pallas"),
        ("NoiseGate", "ballistics", "quadratic", "composed"),
        ("NoiseGate", "ballistics", "quadratic", "pallas"),
        # grafx_tpu runs a one-pole smoother through onepole_exact; the
        # port through the fused walk with at == rt
        ("NoiseGate", "iir_exact", "quadratic", "composed"),
        ("Compressor", None, "hard", "composed"),
        ("NoiseGate", None, "exponential", "composed"),
    ],
)
def test_dynamics_match(cls, smoother, knee, jax_path, request):
    if jax_path == "pallas":
        request.getfixturevalue("pallas_interpret")
    make = lambda m: getattr(m, cls)(energy_smoother=smoother, knee=knee)  # noqa: E731
    got, ref = run_both(make(jp), make(tp), None)
    # fused kernel vs composition: the gain bound of
    # test_pair_kernel_args_onepole_mapping (rtol 2e-4), on the output
    assert max_rel(got, ref) < 2e-4


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.StereoGain(),
        lambda m: m.TanhDistortion(),
        lambda m: m.TanhDistortion(inverse_post_gain=False, remove_dc=True, use_bias=True),
    ],
)
def test_gain_and_distortion_match(make):
    got, ref = run_both(make(jp), make(tp), None)
    assert max_rel(got, ref) < 1e-6


@pytest.mark.parametrize("channel", ["pseudo_midside", "midside", "stereo"])
def test_reverb_matches(channel):
    jproc = jp.STFTMaskedNoiseReverb(ir_len=30000, processor_channel=channel)
    tproc = tp.STFTMaskedNoiseReverb(ir_len=30000, processor_channel=channel)
    np.testing.assert_array_equal(tproc.noise_stft.numpy(), jproc.noise_stft)
    got, ref = run_both(jproc, tproc, None, N=2)
    # istft (matmul vs FFT inverse DFT) + a 2^16-point FFT convolution
    assert max_rel(got, ref) < 1e-4


def test_fused_biquad_chain_matches():
    members = lambda m: [  # noqa: E731
        ("0_eq", m.ParametricEqualizer(num_filters=6, backend="exact")),
        ("1_geq", m.GraphicEqualizer(scale="bark", backend="exact")),
    ]
    jchain = jfuse.FusedBiquadChain(members(jp))
    tchain = tfuse.FusedBiquadChain(members(tp))
    got, ref = run_both(jchain, tchain, None, N=4)
    assert max_rel(got, ref) < 1e-4


@pytest.mark.parametrize("gate_smoother", ["iir_exact", "ballistics"])
@pytest.mark.parametrize("jax_path", ["composed", "pallas"])
def test_fused_dynamics_chain_matches(gate_smoother, jax_path, request):
    if jax_path == "pallas":
        request.getfixturevalue("pallas_interpret")
    members = lambda m: [  # noqa: E731
        ("0_noisegate", m.NoiseGate(energy_smoother=gate_smoother)),
        ("1_compressor", m.Compressor(energy_smoother="ballistics")),
    ]
    jchain = jfuse.FusedDynamicsChain(members(jp))
    tchain = tfuse.FusedDynamicsChain(members(tp))
    N = 6
    rng = np.random.default_rng(5)
    params = random_params(tchain.parameter_size(), N, rng)
    # padded rows: the gate is absent on rows 1, 3 and 5
    params["_absent"] = np.zeros((N, 2), np.float32)
    params["_absent"][1::2, 0] = 1.0
    got, ref = run_both(jchain, tchain, params, N=N)
    assert max_rel(got, ref) < 2e-4

    # an absent gate is the exact identity: those rows equal the lone
    # compressor on the same input
    x = torch.tensor(np.random.default_rng(0).standard_normal((N, 2, L)).astype(np.float32))
    comp = tp.Compressor(energy_smoother="ballistics")
    alone = comp(x, **to_torch(params["1_compressor"])).numpy()
    np.testing.assert_array_equal(got[1::2], alone[1::2])


@pytest.mark.parametrize(
    "scale", ["bark_traunmuller", "bark_schroeder", "bark_wang", "mel_htk", "mel_slaney", "linear", "log"]
)
def test_frequency_scales_match(scale):
    from grafx_tpu.processors.core import scale as jscale
    from grafx_tpu_torch.processors.core import scale as tscale

    freqs = np.geomspace(20.0, 20000.0, 64)
    s = tscale.to_scale(freqs, scale)
    np.testing.assert_array_equal(s, jscale.to_scale(freqs, scale))
    np.testing.assert_array_equal(tscale.from_scale(s, scale), jscale.from_scale(s, scale))
    np.testing.assert_allclose(tscale.from_scale(s, scale), freqs, rtol=1e-9)
