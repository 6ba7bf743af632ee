"""The dynamics processors off the fused gain path against grafx_tpu:
FactorizedCompressor, the Approx pair, the envelope followers and the
composed compressors, each forward and under jax.value_and_grad on the
same numpy inputs and parameters; and a FactorizedCompressor inside a
fused dynamics chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu.render import fuse as jfuse
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.ops import ballistics as bal
from grafx_tpu_torch.processors import dynamics as tdyn
from grafx_tpu_torch.render import fuse as tfuse
from test_torch_processors import max_rel, random_params, to_jax, to_torch
from test_torch_train import count_calls

N, L = 3, 2**12
OUT_REL = 2e-4  # the output bound of test_torch_processors.test_dynamics_match
GRAD_DB = -60.0  # each parameter's gradient, relative L2


def db(err, ref):
    return 20 * np.log10(np.linalg.norm(err) / np.linalg.norm(ref))


def noise(rng, shape, quiet, block=256):
    """Noise with quiet passages (``quiet`` times the level in half of the
    blocks of ``block`` samples), so that knees and gates act."""
    x = rng.standard_normal(shape[:-1] + (-(-shape[-1] // block) * block,))
    loud = rng.random(shape[:-2] + (1, x.shape[-1] // block)) < 0.5
    return (x * np.where(loud, 1.0, quiet).repeat(block, axis=-1))[..., : shape[-1]].astype(np.float32)


def value_and_grads(jproc, tproc, params=None, n=N, length=L, quiet=0.01, seed=0):
    """Both processors' outputs and the gradients of ``sum(out * w)``
    with respect to every parameter, for one random input and weight."""
    rng = np.random.default_rng(seed)
    x = noise(rng, (n, 2, length), quiet)
    assert jproc.parameter_size() == tproc.parameter_size()
    p = random_params(tproc.parameter_size(), n, rng) if params is None else params
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    out = tproc(torch.tensor(x), **leaves)
    w = rng.standard_normal(out.shape).astype(np.float32)
    (out * torch.tensor(w)).sum().backward()

    def loss_j(pj):
        y = jproc(jnp.asarray(x), **pj)
        return jnp.sum(y * w), y

    (_, ref), grads_j = jax.value_and_grad(loss_j, has_aux=True)(to_jax(p))
    grads = {k: v.grad.numpy() for k, v in leaves.items()}
    return out.detach().numpy(), np.asarray(ref), grads, jax.tree.map(np.asarray, grads_j)


def assert_match(jproc, tproc, params=None, **kw):
    got, ref, grads, grads_j = value_and_grads(jproc, tproc, params, **kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert max_rel(got, ref) < OUT_REL
    assert grads.keys() == grads_j.keys()
    for k, g in grads.items():
        ref = grads_j[k]
        assert np.isfinite(g).all(), k
        if k.startswith("z_alpha"):  # every smoother coefficient has a gradient
            assert np.all(ref != 0), k
        if np.any(ref != 0):
            assert db(g - ref, ref) <= GRAD_DB, (k, db(g - ref, ref))
        else:  # e.g. a knee that no sample reaches
            assert np.all(g == 0), k


@pytest.mark.parametrize(
    "frame_len, length, knee",
    [
        (256, L, "quadratic"),
        (256, 3000, "quadratic"),  # ragged: the last frame is zero-padded
        (128, L, "hard"),
    ],
)
def test_factorized_compressor_matches(frame_len, length, knee):
    make = lambda m: m.FactorizedCompressor(frame_len=frame_len, knee=knee)  # noqa: E731
    assert_match(make(jp), make(tp), length=length)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.ApproxCompressor(iir_len=2048),
        lambda m: m.ApproxNoiseGate(freq_sample_n=2048),
        lambda m: m.IIREnvelopeFollower(iir_len=1024),
        lambda m: m.BallisticsEnvelopeFollower(),
        lambda m: m.BallisticsEnvelopeFollower(detect_with="amplitude"),
        lambda m: m.IIREnvelopeFollower(detect_with="rms_channel", iir_len=1024),
    ],
)
def test_approx_processors_and_followers_match(make):
    """Their truncated one-pole smoother is an FFT convolution, whose
    float32 round-off scales with the loudest sample: at -40 dB passages
    (energy 1e-4) the log envelope carries ~1e-3 of it in either package
    (each as far from a float64 evaluation as from the other), so these
    run on -20 dB passages, where the gates still act."""
    assert_match(make(jp), make(tp), quiet=0.1)


BAL, EXACT = dict(energy_smoother="ballistics"), dict(energy_smoother="iir_exact")
LIN, LOG = dict(gain_smoother="ballistics"), dict(gain_smoother="ballistics", gain_smooth_in_log=True)
C, G = ("Compressor", "compressor"), ("NoiseGate", "noisegate")
FC = ("FactorizedCompressor", "compressor")
GAIN_OP_CASES = {
    # one compressor or gate: the fused gain op, the chain, or composed
    "comp-iir": ([(C, dict(energy_smoother="iir"))], None),  # the truncated one-pole composes
    "gate-iir": ([(G, dict(energy_smoother="iir"))], None),
    "comp-none": ([(C, dict(energy_smoother=None))], None),
    "comp-exact": ([(C, EXACT)], ("gain", ((C[1], None),))),
    "comp-ballistics": ([(C, BAL)], ("gain", ((C[1], None),))),
    "gate-exact": ([(G, EXACT)], ("gain", ((G[1], None),))),
    "gate-ballistics": ([(G, BAL)], ("gain", ((G[1], None),))),
    "comp-hard": ([(C, dict(BAL, knee="hard"))], None),
    "comp-exponential": ([(C, dict(BAL, knee="exponential"))], None),
    "gate-exact-exponential": ([(G, dict(EXACT, knee="exponential"))], None),
    "comp-lin": ([(C, dict(BAL, **LIN))], ("chain", ((C[1], "linear"),))),
    "comp-exact-log": ([(C, dict(EXACT, **LOG))], ("chain", ((C[1], "log"),))),
    "gate-lin": ([(G, dict(BAL, **LIN))], ("chain", ((G[1], "linear"),))),
    "gate-exact-log": ([(G, dict(EXACT, **LOG))], ("chain", ((G[1], "log"),))),
    "comp-lin-hard": ([(C, dict(BAL, **LIN, knee="hard"))], None),
    "comp-iir-lin": ([(C, dict(energy_smoother="iir", **LIN))], None),
    "comp-exact-gain": ([(C, dict(BAL, gain_smoother="iir_exact"))], None),  # a one-pole gain smoother
    "comp-iir-gain": ([(C, dict(BAL, gain_smoother="iir"))], None),
    # a lone factorized compressor: the frame gain op or composed
    "factorized": ([(FC, dict(frame_len=256))], ("frame", ((FC[1], None),))),
    "factorized-hard": ([(FC, dict(frame_len=256, knee="hard"))], None),
    "factorized-exponential": ([(FC, dict(frame_len=256, knee="exponential"))], None),
    "factorized-lin": ([(FC, dict(frame_len=256, **LIN))], None),
    # gate -> compressor runs
    "pair": ([(G, EXACT), (C, BAL)], ("pair", ((G[1], None), (C[1], None)))),
    "pair-ballistics-exact": ([(G, BAL), (C, EXACT)], ("pair", ((G[1], None), (C[1], None)))),
    "pair-then-log": ([(G, EXACT), (C, dict(BAL, **LOG))], ("chain", ((G[1], None), (C[1], "log")))),
    "console": ([(G, dict(EXACT, **LOG)), (C, dict(BAL, **LIN))],
                ("chain", ((G[1], "log"), (C[1], "linear")))),
    "lin-then-plain": ([(G, dict(BAL, **LIN)), (C, EXACT)], ("chain", ((G[1], "linear"), (C[1], None)))),
    "pair-iir": ([(G, dict(energy_smoother="iir")), (C, BAL)], None),
    "pair-off-knees": ([(G, dict(EXACT, knee="exponential")), (C, dict(BAL, **LIN, knee="hard"))], None),
    "gate-then-factorized": ([(G, EXACT), (FC, dict(frame_len=256))], None),
    "lin-then-factorized": ([(G, dict(BAL, **LIN)), (FC, dict(frame_len=256))], None),
    "three": ([(C, dict(BAL, **LIN))] * 3, None),
}


@pytest.mark.parametrize("case", list(GAIN_OP_CASES))
def test_each_configuration_takes_its_gain_op(case):
    """The op that serves a dynamics run (processors.dynamics.gain_op),
    decided from the members' configurations alone and held from
    construction by a lone processor and by a FusedDynamicsChain of the
    run: quadratic knees and ballistics or exact one-pole energy take the
    fused gain ops (one member: the gain op, two: the pair walk), and the
    chain where some member smooths its gain with ballistics; a lone
    quadratic-knee FactorizedCompressor without a gain smoother takes the
    frame gain op; the rest compose."""
    members, want = GAIN_OP_CASES[case]
    procs = [getattr(tp, cls)(**kwargs) for (cls, _), kwargs in members]
    assert tdyn.gain_op(procs) == want
    assert tfuse.FusedDynamicsChain([(f"{i}_m", p) for i, p in enumerate(procs)]).gain_op == want
    if len(procs) == 1:
        assert procs[0].gain_op == want
        assert procs[0].chain_spec == (want[1] if want is not None and want[0] == "chain" else None)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(energy_smoother="ballistics", knee="hard"),
        dict(energy_smoother="ballistics", knee="exponential"),
        dict(energy_smoother="ballistics", gain_smoother="ballistics"),
        dict(energy_smoother="iir_exact", gain_smoother="ballistics", gain_smooth_in_log=True),
    ],
)
def test_composed_compressors_match(kwargs):
    """Configurations off the fused gain op: the smoother (the plain
    ballistics walk with its adjoint) composed with the knee."""
    assert getattr(tp.Compressor(**kwargs).gain_op, "name", None) in (None, "chain")
    assert_match(jp.Compressor(**kwargs), tp.Compressor(**kwargs))


def test_factorized_compressor_never_takes_the_fused_gain(monkeypatch):
    """Its smoother is not a per-sample walk: no fused recursion, and
    neither the forward nor the gradient reaches ballistics_gain_core;
    the frames go through the frame gain op (its primal, forward and
    adjoint: the plain versions on the CPU)."""

    def refuse(*args, **kwargs):
        raise AssertionError("FactorizedCompressor reached ballistics_gain_core")

    monkeypatch.setattr(tdyn, "ballistics_gain_core", refuse)
    comp = tp.FactorizedCompressor(frame_len=256)
    assert comp.gain_op.name == "frame"
    assert comp.parameter_size() == tp.Compressor(energy_smoother="ballistics").parameter_size()
    calls = count_calls(
        monkeypatch, bal, ("frame_gain_plain", "frame_gain_fwd_plain", "frame_gain_bwd_plain")
    )
    rng = np.random.default_rng(1)
    x = torch.tensor(noise(rng, (N, 2, L), 0.01))
    p = to_torch(random_params(comp.parameter_size(), N, rng))
    with torch.no_grad():
        comp(x, **p)
    assert calls == {"frame_gain_plain": 1, "frame_gain_fwd_plain": 1}
    p["z_alpha_pre"].requires_grad_()
    comp(x, **p).sum().backward()
    assert calls == {"frame_gain_plain": 1, "frame_gain_fwd_plain": 2, "frame_gain_bwd_plain": 1}
    assert bool((p["z_alpha_pre"].grad != 0).all())
    with pytest.raises(NotImplementedError, match="no compact per-sample state"):
        comp.stream_init(2, 1024, **p)


def test_fused_chain_with_factorized_member_matches(monkeypatch):
    """A gate -> FactorizedCompressor run composes: the gate member takes
    its own fused gain op, the compressor its frame smoother, and the
    absent gates' rows equal the lone compressor (gain 1 selected)."""
    members = lambda m: [  # noqa: E731
        ("0_noisegate", m.NoiseGate(energy_smoother="iir_exact")),
        ("1_compressor", m.FactorizedCompressor(frame_len=256)),
    ]
    jchain, tchain = jfuse.FusedDynamicsChain(members(jp)), tfuse.FusedDynamicsChain(members(tp))
    n = 6
    rng = np.random.default_rng(5)
    params = random_params(tchain.parameter_size(), n, rng)
    params["_absent"] = np.zeros((n, 2), np.float32)
    params["_absent"][1::2, 0] = 1.0
    assert tchain.gain_op is None
    calls = count_calls(monkeypatch, tdyn, ("ballistics_gain_core",))
    x = noise(np.random.default_rng(0), (n, 2, L), 0.01)
    got = tchain(torch.tensor(x), **to_torch(params)).numpy()
    assert calls == {"ballistics_gain_core": 1}  # the gate member only
    ref = np.asarray(jchain(jnp.asarray(x), **to_jax(params)))
    assert max_rel(got, ref) < OUT_REL
    alone = tp.FactorizedCompressor(frame_len=256)(torch.tensor(x), **to_torch(params["1_compressor"]))
    np.testing.assert_array_equal(got[1::2], alone.numpy()[1::2])
