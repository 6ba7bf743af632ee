"""The dynamics chain op (ops/ballistics.py: ``ballistics_chain_core``, the
port's own kernel for a gain-smoothed compressor or gate, or a gate ->
compressor run of them) against grafx_tpu's composed path: each member's
``Compressor.gain_from_energy`` (the energy smoother, the knee and the
ballistics gain smoother, each walk its own call), threaded as
``grafx_tpu.render.fuse.FusedDynamicsChain`` threads a composite's members.

Covered: one member and two, linear and log gain smoothing, ballistics and
exact one-pole energy, a member without a gain smoother beside one with,
absent members.  Compared, on numpy inputs with -40 dB passages (so that
knees and gates act):

* the forward, within -60 dB of grafx_tpu's (the neighbouring tests'
  bound, tests/test_torch_dynamics.py);
* the forward with residuals against the primal, bit for bit;
* the adjoint against jax.grad of the composed function: the cotangent of
  the energy and of every parameter (each chain constant is a function of
  one leaf: at/rt of z_alpha_pre, th of log_threshold, cf of log_ratio, hk
  of log_knee, the gain walk's at/rt of z_alpha_post), each within GRAD_DB
  in float64, as tests/test_torch_gain_smoothed_console.py holds them
  (float32 determines a gate's leaves only to -18 to -44 dB in either
  package); in float32 the energy's cotangent and the concatenated
  gradient within -60 dB of grafx_tpu's, or within grafx_tpu's own
  float32 spread (against its float64) + 6 dB where float32 determines
  them less (a log-smoothed gate's energy cotangent: -55 dB apart);
* the adjoint of every constant and initial state against torch autograd
  through the plain forward (which holds the decisions as the adjoint
  does), in float64;
* the stream split in two blocks against one call, and the final states,
  bit for bit; an absent member's gain exactly 1 and its gradients 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.ops import ballistics as bal
import grafx_tpu_torch.processors.dynamics as tdyn
from grafx_tpu_torch.processors.dynamics import dynamics_chain, gain_op, request_states
from test_torch_dynamics import db, noise
from test_torch_processors import random_params

N, L = 6, 512
GRAD_DB = -60.0  # tests/test_torch_dynamics.py: each dynamics parameter's gradient
OUT_DB = -60.0

# member constructors: (package -> processor)
COMP_BAL_LIN = ("compressor ballistics linear",
                lambda m: m.Compressor(energy_smoother="ballistics", gain_smoother="ballistics"))
GATE_EXACT_LOG = ("gate one-pole log",
                  lambda m: m.NoiseGate(energy_smoother="iir_exact", gain_smoother="ballistics",
                                        gain_smooth_in_log=True))
COMP_EXACT_LOG = ("compressor one-pole log",
                  lambda m: m.Compressor(energy_smoother="iir_exact", gain_smoother="ballistics",
                                         gain_smooth_in_log=True))
GATE_BAL_LIN = ("gate ballistics linear",
                lambda m: m.NoiseGate(energy_smoother="ballistics", gain_smoother="ballistics"))
GATE_BAL = ("gate ballistics", lambda m: m.NoiseGate(energy_smoother="ballistics"))
COMP_EXACT = ("compressor one-pole", lambda m: m.Compressor(energy_smoother="iir_exact"))

RUNS = {
    "comp-lin": [COMP_BAL_LIN],
    "gate-log": [GATE_EXACT_LOG],
    "comp-onepole-log": [COMP_EXACT_LOG],
    "gate-lin": [GATE_BAL_LIN],
    "console": [GATE_EXACT_LOG, COMP_BAL_LIN],  # the gain-smoothed console's composite
    "gate-then-log": [GATE_BAL, COMP_EXACT_LOG],
    "log-then-plain": [GATE_BAL_LIN, COMP_EXACT],
}


def members(run, m):
    return [(f"{i}_{name.split()[0]}", make(m)) for i, (name, make) in enumerate(RUNS[run])]


def draw(run, seed, absent=False, n=N, length=L):
    """Energy ``(n, length)``, each member's parameters, and the present
    mask ``(n, M)`` (every row present unless ``absent``: then member 0
    is absent on every other row, member 1 of two on every third)."""
    rng = np.random.default_rng(seed)
    x = noise(rng, (n, 2, length), 0.01)
    energy = np.mean(np.square(x), axis=-2)
    params = {name: random_params(proc.parameter_size(), n, rng) for name, proc in members(run, tp)}
    present = np.ones((n, len(RUNS[run])), bool)
    if absent:
        present[1::2, 0] = False
        if present.shape[1] == 2:
            present[::3, 1] = False
    return energy, params, present


def jax_gain(run, energy, params, present):
    """grafx_tpu's composed path: each member's gain_from_energy on the
    energy times the squared product of the gains before it, an absent
    member's gain 1 (grafx_tpu/render/fuse.py, FusedDynamicsChain)."""
    gain = None
    for idx, (name, proc) in enumerate(members(run, jp)):
        e = energy if gain is None else jnp.square(gain) * energy
        g = proc.gain_from_energy(e, **params[name])
        g = jnp.where(present[:, idx:idx + 1], g, 1.0)
        gain = g if gain is None else gain * g
    return gain


def port_chain(run, energy, params, present, dtype=torch.float32):
    """The chain's operands from the port's processors (dynamics_chain)."""
    procs = members(run, tp)
    tparams = {k: {p: torch.tensor(v, dtype=dtype, requires_grad=True) for p, v in d.items()}
               for k, d in params.items()}
    spec = gain_op([proc for _, proc in procs]).spec
    consts, inits = dynamics_chain(spec, [(proc, tparams[name]) for name, proc in procs],
                                      torch.tensor(present))
    zi = request_states(consts, inits)
    return spec, consts, zi, tparams


@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("run", list(RUNS))
def test_forward_matches_grafx_tpu(run, absent):
    """The chain's gain (the primal op and the plain forward, which agree
    bit for bit with the residual variant) against grafx_tpu's composed
    path within -60 dB; an absent member's rows are its partner's gain
    alone (exactly 1 for a lone member)."""
    energy, params, present = draw(run, 1 + len(run), absent)
    spec, consts, zi, _ = port_chain(run, energy, params, present)
    u = torch.tensor(energy)
    with torch.no_grad():
        gain, last = bal.ballistics_chain_core(u, consts, zi, spec)
        fwd = bal.ballistics_chain_fwd(u, consts, zi, spec)
    ref = np.asarray(jax_gain(run, jnp.asarray(energy), params, present))
    assert gain.shape == (N, L) and np.isfinite(gain.numpy()).all()
    assert db(gain.numpy() - ref, ref) <= OUT_DB, db(gain.numpy() - ref, ref)
    assert torch.equal(fwd[0], gain) and torch.equal(fwd[2], last)
    assert fwd[1].shape == (len(bal.chain_walks(spec)), N, L) and last.shape == zi.shape
    if absent and len(spec) == 1:
        assert bool((gain[~torch.tensor(present[:, 0])] == 1.0).all())


def jax_grads(run, energy, params, present, w, x64):
    def loss(e, p):
        return jnp.sum(jax_gain(run, e, p, present) * w)

    cast = (lambda v: jnp.asarray(v, jnp.float64)) if x64 else jnp.asarray
    with jax.enable_x64(x64):
        du, dp = jax.grad(loss, argnums=(0, 1))(cast(energy), jax.tree.map(cast, params))
        return np.asarray(du), jax.tree.map(np.asarray, dp)


def port_grads(run, energy, params, present, w, dtype):
    spec, consts, zi, tparams = port_chain(run, energy, params, present, dtype)
    u = torch.tensor(energy, dtype=dtype, requires_grad=True)
    gain = bal.ballistics_chain_core(u, consts, zi, spec)[0]
    (gain * torch.tensor(w, dtype=dtype)).sum().backward()
    return u.grad.numpy(), {k: {p: v.grad.numpy() for p, v in d.items()} for k, d in tparams.items()}


@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("run", list(RUNS))
def test_adjoint_matches_jax_grad(run, absent):
    """The chain under autograd (its forward with residuals, then its
    adjoint) against jax.grad of the composed path: in float64 the energy's
    cotangent and each parameter leaf within GRAD_DB; in float32 the
    concatenated gradient within -60 dB; an absent member's rows exactly 0
    in every leaf of its own."""
    energy, params, present = draw(run, 11 + len(run), absent)
    w = np.random.default_rng(2).standard_normal(energy.shape)
    du64, g64 = port_grads(run, energy, params, present, w, torch.float64)
    rdu64, r64 = jax_grads(run, energy, params, present, w, x64=True)
    assert db(du64 - rdu64, rdu64) <= GRAD_DB
    for name in r64:
        for leaf, ref in r64[name].items():
            got = g64[name][leaf]
            assert np.isfinite(got).all()
            if np.any(ref != 0):
                assert db(got - ref, ref) <= GRAD_DB, (name, leaf, db(got - ref, ref))
            else:  # a knee that no sample reaches
                assert np.all(got == 0), (name, leaf)
    du, g32 = port_grads(run, energy, params, present, w.astype(np.float32), torch.float32)
    rdu, r32 = jax_grads(run, energy, params, present, w.astype(np.float32), x64=False)
    cat = lambda d: np.concatenate([d[k][p].ravel() for k in sorted(d) for p in sorted(d[k])])  # noqa: E731
    for got, ref, ref64 in ((du, rdu, rdu64), (cat(g32), cat(r32), cat(r64))):
        # within -60 dB of grafx_tpu's float32, or no further from float64
        # than grafx_tpu's own float32 is, + 6 dB
        assert db(got - ref, ref) <= -60.0 or db(got - ref64, ref64) <= db(ref - ref64, ref64) + 6.0, (
            db(got - ref, ref), db(got - ref64, ref64), db(ref - ref64, ref64))
    for i, (name, _) in enumerate(members(run, tp)):
        rows = ~present[:, i]
        for leaf, got in g32[name].items():
            assert np.all(got[rows] == 0) and np.all(g64[name][leaf][rows] == 0), (name, leaf)


@pytest.mark.parametrize("run", ["console", "comp-lin", "gate-then-log", "log-then-plain"])
def test_adjoint_matches_autograd_through_the_plain_forward(run):
    """ballistics_chain_bwd's every output (du, each member's constants,
    each walk's initial state) against torch autograd through the plain
    forward, float64; the present rows' and an unsmoothed gain's rows 0."""
    energy, params, present = draw(run, 21, absent=True)
    spec, consts, zi, _ = port_chain(run, energy, params, present, torch.float64)
    consts = consts.detach().requires_grad_()
    zi = (0.5 + torch.rand(zi.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
          ).requires_grad_()
    u = torch.tensor(energy, dtype=torch.float64, requires_grad=True)
    gg = torch.tensor(np.random.default_rng(5).standard_normal(energy.shape))
    gain, d, last = bal.ballistics_chain_fwd_plain(u, consts, zi, spec)
    ref = torch.autograd.grad((gain * gg).sum(), (u, consts, zi))
    with torch.no_grad():
        got = bal.ballistics_chain_bwd(u, d, last, gg, consts, spec)
    for name, g, r in zip(("du", "dconsts", "dzi"), got, ref):
        assert g.shape == r.shape, name
        assert db((g - r).numpy(), r.numpy()) <= -200.0, name
    rows = got[1].reshape(len(spec), len(bal.CHAIN_ROWS), N)
    assert bool((rows[:, bal.CHAIN_ROWS.index("present")] == 0).all())
    for i, (_, smooth) in enumerate(spec):
        if smooth is None:
            assert bool((rows[i, 5:7] == 0).all())
    for i in range(len(spec)):  # each constant row's gradient, row by row
        for q, row in enumerate(bal.CHAIN_ROWS[:5]):
            r = ref[1].reshape(rows.shape)[i, q]
            assert db((rows[i, q] - r).numpy(), r.numpy()) <= -200.0, (i, row)


@pytest.mark.parametrize("run", ["console", "gate-log", "log-then-plain"])
def test_stream_split_equals_one_call(run):
    """The chain over a row split in two calls, the second from the first's
    final states, equals one call bit for bit (gain and final states);
    through the processors, a streamed composite equals its one-shot
    forward."""
    energy, params, present = draw(run, 31, absent=True)
    spec, consts, zi, _ = port_chain(run, energy, params, present)
    u = torch.tensor(energy)
    with torch.no_grad():
        whole, last = bal.ballistics_chain_core(u, consts, zi, spec)
        first, mid = bal.ballistics_chain_core(u[:, :200], consts, zi, spec)
        second, end = bal.ballistics_chain_core(u[:, 200:], consts, mid, spec)
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert torch.equal(end, last)


def test_streamed_composite_and_compressor_match_their_forward():
    """A gate -> compressor composite (tp.FusedDynamicsChain) and a lone
    compressor streamed in blocks of 128 through their stream_step, which
    run the chain from the members' states: equal to their one-shot
    forward bit for bit."""
    from grafx_tpu_torch.render.fuse import FusedDynamicsChain

    energy, params, present = draw("console", 41, absent=True)
    chain = FusedDynamicsChain(members("console", tp))
    rng = np.random.default_rng(41)
    x = torch.tensor(noise(rng, (N, 2, L), 0.01))
    p = {k: {q: torch.tensor(v) for q, v in d.items()} for k, d in params.items()}
    p["_absent"] = torch.tensor((~present).astype(np.float32))
    comp = tp.Compressor(energy_smoother="ballistics", gain_smoother="ballistics")
    pc = p["1_compressor"]
    for proc, kw in ((chain, p), (comp, pc)):
        with torch.no_grad():
            one = proc(x, **kw)
            state, cache = proc.stream_init(2, 128, **kw)
            outs = []
            for xb in x.split(128, dim=-1):
                y, state = proc.stream_step(xb, state, cache)
                outs.append(y)
        assert torch.equal(torch.cat(outs, dim=-1), one)


@pytest.mark.parametrize("case", ["pair", "lone fused", "composed", "factorized"])
def test_other_runs_build_no_chain_operands(monkeypatch, case):
    """Runs the chain does not serve (the pair walk's, a lone fused gain
    op's, composed members', a factorized member's) never build its
    operands: forward, under gradient and streamed block by block, they
    reach neither dynamics_chain nor the chain op."""
    from grafx_tpu_torch.render.fuse import FusedDynamicsChain

    def refuse(*args, **kwargs):
        raise AssertionError("a run off the chain built the chain's operands")

    members = {
        "pair": [tp.NoiseGate(energy_smoother="iir_exact"), tp.Compressor(energy_smoother="ballistics")],
        "lone fused": [tp.Compressor(energy_smoother="ballistics")],
        "composed": [tp.NoiseGate(energy_smoother="iir_exact", knee="exponential"), tp.Compressor(energy_smoother="ballistics", gain_smoother="ballistics",
                                                     knee="hard")],
        "factorized": [tp.NoiseGate(energy_smoother="iir_exact"), tp.FactorizedCompressor(frame_len=128)],
    }[case]
    proc = members[0] if len(members) == 1 else FusedDynamicsChain([(f"{i}_m", p) for i, p in enumerate(members)])
    rng = np.random.default_rng(3)
    p = {k: torch.tensor(v) if isinstance(v, np.ndarray) else {q: torch.tensor(w) for q, w in v.items()}
         for k, v in random_params(proc.parameter_size(), N, rng).items()}
    if "_absent" in p:
        p["_absent"] = torch.zeros(N, len(members))
    x = torch.tensor(noise(rng, (N, 2, L), 0.01))
    for name in ("dynamics_chain", "ballistics_chain_core"):
        monkeypatch.setattr(tdyn, name, refuse)
    with torch.no_grad():
        one = proc(x, **p)
    leaf = next(iter(p.values())) if len(members) == 1 else p["0_m"]["log_threshold"]
    leaf.requires_grad_()
    proc(x, **p).sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    if case != "factorized":  # no compact stream state
        with torch.no_grad():
            state, cache = proc.stream_init(2, 128, **p)
            for xb in x.split(128, dim=-1):
                state = proc.stream_step(xb, state, cache)[1]
    assert one.shape == x.shape and bool(torch.isfinite(one).all())


def test_chain_code_round_trips_and_refuses():
    for spec in [(("compressor", "linear"),), (("noisegate", "log"), ("compressor", "linear")),
                 (("noisegate", None), ("compressor", "log")), (("compressor", None),)]:
        assert bal.chain_spec(bal.chain_code(spec)) == spec
    assert bal.chain_code((("noisegate", "log"), ("compressor", "linear"))) == 0b010_101_1  # member 1: linear, compressor; member 0: log, gate; two members
    with pytest.raises(ValueError, match="one or two members"):
        bal.chain_code((("compressor", "log"),) * 3)


def test_custom_op_passes_opcheck_and_wrappers_refuse_other_devices():
    """The primal as ``torch.ops.grafx_tpu_torch.ballistics_chain``:
    schema, fake implementation and dispatch pass opcheck, and it is the
    plain version on the CPU; the wrappers refuse a device that is
    neither the CPU nor CUDA."""
    energy, params, present = draw("console", 51, n=3, length=200)
    spec, consts, zi, _ = port_chain("console", energy, params, present)
    args = (torch.tensor(energy), consts.detach(), zi, bal.chain_code(spec))
    overload = torch.ops.grafx_tpu_torch.ballistics_chain.default
    torch.library.opcheck(overload, args)
    got = overload(*args)
    ref = bal.ballistics_chain_plain(args[0], args[1], zi, spec)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    u, c = torch.empty(2, 8, device="meta"), torch.empty(16, 2, device="meta")
    z = torch.empty(4, 2, device="meta")
    for call in (lambda: bal.ballistics_chain_core(u, c, z, spec),
                 lambda: bal.ballistics_chain_fwd(u, c, z, spec),
                 lambda: bal.ballistics_chain_bwd(u, z[:, :, None].expand(4, 2, 8), z, u, c, spec)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
