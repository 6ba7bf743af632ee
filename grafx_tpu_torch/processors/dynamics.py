"""Dynamics processors: compressors, noise gates and envelope followers
(the port of :mod:`grafx_tpu.processors.dynamics`; reference:
src/grafx/processors/dynamics.py:8-784).

A dynamics run is a lone compressor or gate, or the members of a fused
serial run of them (``render.fuse.FusedDynamicsChain``).  Which op
computes a run's gain is decided here and nowhere else: :func:`gain_op`
decides it from the members' configurations alone, once when the
processor or the run is built, which holds it as ``gain_op``.  The ops:

* ``"frame"``: a lone :class:`FactorizedCompressor` with a quadratic knee
  and no gain smoother; its pool, frame walk, lerp and knee in one op
  (:func:`~grafx_tpu_torch.ops.ballistics.frame_gain_core`);
* ``"gain"``: one member with a quadratic knee, no gain smoother and a
  ballistics or exact one-pole energy smoother; the smoother and the knee
  in one op (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_gain_core`).
  A one-pole smoother is the ``at == rt == 1 - alpha`` case of that
  recursion with initial state 0, and its trailing relu is a no-op on
  nonnegative energy;
* ``"pair"``: two such members, in one walk over time
  (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_gain_pair_core`);
* ``"chain"``: one or two members that qualify as walks
  (:func:`_walk_member`), some of which smooth their gain with
  ballistics; every energy and gain walk of the run in one op
  (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_chain_core`, the
  port's own kernel), forward, under gradient and streamed;
* ``None``: composed.  A lone processor runs its smoother
  (:mod:`~grafx_tpu_torch.processors.core.envelope`; a factorized one its
  frame smoother) and the knee math; a run's members each run their own
  op and the gains multiply.

:func:`dynamics_gain` computes a run's gain from its op, its members'
parameters and its ``_absent`` mask; :func:`dynamics_gain_stream` a
stream block's: the chain where it serves the run (the chain returns
every walk's final state), else composed, as ``grafx_tpu`` does: the
fused gain ops do not return the final envelope a stream carries into
its next block.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch import profiling
from grafx_tpu_torch.ops.ballistics import (
    ballistics_chain_core,
    ballistics_chain_stream,
    ballistics_gain_core,
    ballistics_gain_pair_core,
    frame_gain_core,
    frame_lerp,
    frame_means,
)
from grafx_tpu_torch.processors.core.envelope import Ballistics, TruncatedOnePoleIIRFilter


def _make_smoother(kind, iir_len, **backend_kwargs):
    match kind:
        case "iir":
            return TruncatedOnePoleIIRFilter(iir_len=iir_len, **backend_kwargs)
        case "iir_exact":
            return TruncatedOnePoleIIRFilter(exact=True, **backend_kwargs)
        case "ballistics":
            return Ballistics()
        case None:
            return None
        case _:
            raise ValueError(f"Unknown smoother: {kind}")


class GainOp(NamedTuple):
    """The op that serves a dynamics run (:func:`gain_op`): ``name``,
    ``"frame"``, ``"gain"``, ``"pair"`` or ``"chain"``, and ``spec``, each
    member's ``(kind, smooth)`` (:func:`_walk_member`)."""

    name: str
    spec: tuple


def _walk_member(proc):
    """``(kind, smooth)`` of ``proc`` in a walk op, from its configuration
    alone: ``smooth`` is ``None`` without a gain smoother, else ``"log"``
    or ``"linear"``; ``None`` unless the knee is quadratic, the energy
    smoother a ballistics or exact one-pole recursion
    (:func:`smoother_recursion`) and the gain smoother, if any, ballistics
    (a one-pole gain smoother ends in a relu, which the walk lacks, and a
    log gain is negative)."""
    energy, gain = proc.energy_smoother_module, proc.gain_smoother_module
    exact = isinstance(energy, TruncatedOnePoleIIRFilter) and energy.exact
    if proc.knee != "quadratic" or not (exact or isinstance(energy, Ballistics)):
        return None
    if gain is None:
        return proc._fused_kind, None
    if not isinstance(gain, Ballistics):
        return None
    return proc._fused_kind, "log" if proc.gain_smooth_in_log else "linear"


def gain_op(procs):
    """The :class:`GainOp` that serves a run of ``procs`` (one or two
    compressors or gates, in order), or ``None`` where the run composes;
    from their configurations alone (the module docstring has the
    rules)."""
    if len(procs) == 1 and isinstance(procs[0], FactorizedCompressor):
        proc = procs[0]
        if proc.knee == "quadratic" and proc.gain_smoother is None:
            return GainOp("frame", ((proc._fused_kind, None),))
        return None
    spec = tuple(_walk_member(proc) for proc in procs)
    if not 1 <= len(spec) <= 2 or None in spec:
        return None
    if any(smooth is not None for _, smooth in spec):
        return GainOp("chain", spec)
    return GainOp("gain" if len(spec) == 1 else "pair", spec)


def smoother_recursion(smoother, z_alpha):
    """``(at, rt, init)`` of the ballistics recursion equal to
    ``smoother`` with pre-sigmoid coefficients ``z_alpha``, or ``None``
    when the smoother is not one."""
    if isinstance(smoother, Ballistics):
        ts = torch.sigmoid(z_alpha)
        return ts[..., 0], ts[..., 1], 1.0
    if isinstance(smoother, TruncatedOnePoleIIRFilter) and smoother.exact:
        alpha = torch.clamp(torch.sigmoid(z_alpha[..., 0]), max=1.0 - 1e-5)
        return 1.0 - alpha, 1.0 - alpha, 0.0
    return None


def dynamics_chain(spec, members, present=None):
    """The operands of the dynamics chain op for a run of ``members``,
    ``[(processor, params)]`` of spec ``spec`` (:attr:`GainOp.spec`;
    ``present``: ``(N, M)`` bool, False where a member is absent):
    ``(consts, inits)``, its ``(8 M, N)`` constants and a request's initial
    state of each walk (1 for ballistics and a gain, 0 for the one-pole;
    :func:`request_states`; a stream passes its own)."""
    rows, inits = [], []
    for i, ((_, smooth), (proc, p)) in enumerate(zip(spec, members)):
        at, rt, init = smoother_recursion(proc.energy_smoother_module, p["z_alpha_pre"])
        th, cf, hk = proc.knee_constants(p["log_threshold"], p["log_ratio"], p["log_knee"])
        keep = torch.ones_like(cf) if present is None else present[..., i].to(cf.dtype)
        if smooth is None:
            at_g = rt_g = torch.zeros_like(at)
            inits.append(init)
        else:
            at_g, rt_g, gain_init = smoother_recursion(proc.gain_smoother_module, p["z_alpha_post"])
            inits += [init, gain_init]
        rows += [at, rt, th, cf, hk, at_g, rt_g, keep]
    return torch.stack(rows), inits


def request_states(consts, inits):
    """The chain's ``(R, N)`` initial states of a request from
    :func:`dynamics_chain`'s ``inits``."""
    return torch.stack([torch.full_like(consts[0], v) for v in inits])


def _walk_keys(smooth):
    return ("energy",) if smooth is None else ("energy", "gain")


def chain_states(spec, states):
    """The chain's stream state ``(last, tail)``
    (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_chain_stream`) from
    the members' stream states (``{"energy": ..., "gain": ...}`` each):
    the ``(R, N)`` states of its walks, in walk order, and the samples of
    the link the last block ended in, which each ballistics walk's state
    ``(last, tail)`` carries (a one-pole's is its last sample alone)."""
    walks = [state[key] for (_, smooth), state in zip(spec, states) for key in _walk_keys(smooth)]
    tail = next(w[1] for w in walks if isinstance(w, tuple))  # every chain walks a ballistics gain
    return torch.stack([w[0] if isinstance(w, tuple) else w for w in walks]), tail


def member_states(spec, state, like):
    """The members' stream states from the chain's ``(last, tail)``, each
    walk's in the form it has in ``like`` (the inverse of
    :func:`chain_states`)."""
    last, tail = state
    states, r = [], 0
    for (_, smooth), old in zip(spec, like):
        new = {"energy": None, "gain": None}
        for key in _walk_keys(smooth):
            new[key] = (last[r], tail) if isinstance(old[key], tuple) else last[r]
            r += 1
        states.append(new)
    return states


def _unless_absent(gain, absent, i):
    """``gain``, exactly 1 on the rows where member ``i`` is absent."""
    return gain if absent is None else torch.where(absent[..., i : i + 1] > 0.5, 1.0, gain)


def _composed(members, energy, absent, member_gain):
    """The composed path: member ``i`` gets the energy times the squared
    product of the gains before it, ``member_gain(i, e_i)`` returns its
    gain, and an absent member's gain is 1."""
    gain = None
    for i in range(len(members)):
        e = energy if gain is None else torch.square(gain) * energy
        g = _unless_absent(member_gain(i, e), absent, i)
        gain = g if gain is None else gain * g
    return gain


def dynamics_gain(op, members, energy, absent=None):
    """The ``(N, L)`` gain of a run of ``members``, ``[(processor,
    params)]``, from its ``(N, L)`` energy, by ``op`` (:func:`gain_op`).
    ``absent``: the run's ``(N, M)`` ``_absent`` mask (> 0.5 = absent),
    where a member's gain is exactly 1 (``cf = 0`` on the pair walk,
    ``present`` on the chain, selected elsewhere)."""
    name = None if op is None else op.name
    if name is None and len(members) > 1:
        profiling.count("grafx.dynamics.composed")
        return _composed(members, energy, absent,
                         lambda i, e: dynamics_gain(members[i][0].gain_op, [members[i]], e))
    if name == "chain":
        consts, inits = dynamics_chain(op.spec, members, None if absent is None else absent <= 0.5)
        return ballistics_chain_core(energy, consts, request_states(consts, inits), op.spec)[0]
    if name == "pair":
        consts, inits = [], []
        for i, (proc, p) in enumerate(members):
            at, rt, init = smoother_recursion(proc.energy_smoother_module, p["z_alpha_pre"])
            th, cf, hk = proc.knee_constants(p["log_threshold"], p["log_ratio"], p["log_knee"])
            if absent is not None:  # cf = 0 -> gain = exp(0 * f) = 1 exactly
                cf = cf * (absent[..., i] <= 0.5).to(cf.dtype)
            consts += [at, rt, th, cf, hk]
            inits.append(init)
        kinds = tuple(kind for kind, _ in op.spec)
        return ballistics_gain_pair_core(energy, *consts, kinds, tuple(inits))
    ((proc, p),) = members
    if name == "gain":
        at, rt, init = smoother_recursion(proc.energy_smoother_module, p["z_alpha_pre"])
        th, cf, hk = proc.knee_constants(p["log_threshold"], p["log_ratio"], p["log_knee"])
        zi = torch.full_like(at, init)
        gain = ballistics_gain_core(energy, zi, at, rt, th, cf, hk, proc._fused_kind)
    elif name == "frame":
        # the tracer's device interval of the pool, the walk, the lerp and
        # the knee, and the frames walked (rows x frames), all by the op
        with profiling.span("grafx.dynamics.frame", energy.device):
            ts = torch.sigmoid(p["z_alpha_pre"])
            th, cf, hk = proc.knee_constants(p["log_threshold"], p["log_ratio"], p["log_knee"])
            gain = frame_gain_core(energy, ts[..., 0], ts[..., 1], th, cf, hk, proc.frame_len)
            frames = energy.shape[0] * -(-energy.shape[-1] // proc.frame_len)
            profiling.count("ballistics.frame.frames", frames)
            profiling.count("ballistics.frame.fused", frames)
    else:
        gain = proc._composed_gain(energy, **p)
    return _unless_absent(gain, absent, 0)


def dynamics_gain_stream(op, members, energy, states, absent=None):
    """One block of a streamed :func:`dynamics_gain`: ``(gain, states)``,
    with ``members`` ``[(processor, stream cache)]`` and ``states`` each
    member's stream state (``{"energy": ..., "gain": ...}``).  The chain
    where it serves the run, from the members' states; else composed."""
    if op is not None and op.name == "chain":
        consts, _ = dynamics_chain(op.spec, members, None if absent is None else absent <= 0.5)
        gain, new = ballistics_chain_stream(energy, consts, chain_states(op.spec, states), op.spec)
        return gain, member_states(op.spec, new, states)
    if len(members) == 1:
        ((proc, cache),), (state,) = members, states
        gain, state = proc._composed_stream(energy, state, cache)
        return _unless_absent(gain, absent, 0), [state]
    new = []

    def member_gain(i, e):
        gain, (state,) = dynamics_gain_stream(members[i][0].gain_op, [members[i]], e, [states[i]])
        new.append(state)
        return gain

    return _composed(members, energy, absent, member_gain), new


class Compressor(nn.Module):
    """Feed-forward compressor with selectable energy/gain smoothing and
    knee shape (reference: dynamics.py:213-489)."""

    _fused_kind = "compressor"
    #: joins the "dynamics" graph-fusion family (render/fuse.py): the
    #: node's effect is ``y = gain(mean(x^2, ch)) * x``.
    dynamics_fusable = True

    def __init__(
        self,
        energy_smoother="iir",
        gain_smoother=None,
        gain_smooth_in_log=False,
        knee="quadratic",
        iir_len=16384,
        **backend_kwargs,
    ):
        super().__init__()
        self.energy_smoother = energy_smoother
        self.energy_smoother_module = _make_smoother(energy_smoother, iir_len, **backend_kwargs)
        self.gain_smoother = gain_smoother
        self.gain_smoother_module = _make_smoother(gain_smoother, iir_len, **backend_kwargs)
        if knee not in ("hard", "quadratic", "exponential"):
            raise ValueError(f"Unknown knee: {knee}")
        self.knee = knee
        self.gain_smooth_in_log = gain_smooth_in_log
        #: the op that serves this processor alone (:func:`gain_op`)
        self.gain_op = gain_op([self])

    @property
    def chain_spec(self):
        """:attr:`gain_op`'s spec where the dynamics chain serves this
        processor, else None."""
        return self.gain_op.spec if self.gain_op is not None and self.gain_op.name == "chain" else None

    def forward(
        self,
        input_signals,
        log_threshold,
        log_ratio,
        log_knee=None,
        z_alpha_pre=None,
        z_alpha_post=None,
    ):
        """Compress ``(N, C, L)`` signals."""
        energy = torch.mean(torch.square(input_signals), dim=-2)
        gain = self.gain_from_energy(
            energy,
            log_threshold,
            log_ratio,
            log_knee=log_knee,
            z_alpha_pre=z_alpha_pre,
            z_alpha_post=z_alpha_post,
        )
        return gain[:, None, :] * input_signals

    def knee_constants(self, log_threshold, log_ratio, log_knee):
        """``(th, cf, hk)`` of the fused ops: shifted threshold, knee
        coefficient and half-knee, each ``(N,)``."""
        ratio = 1.0 + torch.exp(log_ratio[..., 0])
        cf = 1.0 / ratio - 1.0 if self._fused_kind == "compressor" else ratio - 1.0
        return log_threshold[..., 0] - 6.0, cf, torch.exp(log_knee[..., 0]) / 2.0

    def gain_from_energy(
        self,
        energy,
        log_threshold,
        log_ratio,
        log_knee=None,
        z_alpha_pre=None,
        z_alpha_post=None,
    ):
        """Linear gain time series from the ``(N, L)`` input energy, by
        :attr:`gain_op` (:func:`dynamics_gain`)."""
        params = dict(log_threshold=log_threshold, log_ratio=log_ratio, log_knee=log_knee,
                      z_alpha_pre=z_alpha_pre, z_alpha_post=z_alpha_post)
        return dynamics_gain(self.gain_op, [(self, params)], energy)

    def _composed_gain(self, energy, log_threshold, log_ratio, log_knee=None, z_alpha_pre=None,
                       z_alpha_post=None):
        """:meth:`gain_from_energy` composed: the smoothers and the knee."""
        if self.energy_smoother_module is not None:
            energy = self.energy_smoother_module(energy, z_alpha=z_alpha_pre)
        log_energy = torch.log(energy + 1e-5)
        log_gain = self.compute_gain(log_energy, log_threshold - 6.0, log_ratio, log_knee)
        if self.gain_smoother_module is not None:
            if self.gain_smooth_in_log:
                return torch.exp(self.gain_smoother_module(log_gain, z_alpha=z_alpha_post))
            return self.gain_smoother_module(torch.exp(log_gain), z_alpha=z_alpha_post)
        return torch.exp(log_gain)

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, **params):
        """Streaming contract (render/streaming.py): carry the energy
        (and optional gain) smoother states across blocks."""
        del num_channels, block_len
        n, device = params["log_threshold"].shape[0], params["log_threshold"].device
        state = {
            "energy": None if self.energy_smoother_module is None
            else self.energy_smoother_module.stream_zero_state(n, device),
            "gain": None if self.gain_smoother_module is None
            else self.gain_smoother_module.stream_zero_state(n, device),
        }
        return state, dict(params)

    def stream_step(self, x, state, cache):
        energy = torch.mean(torch.square(x), dim=-2)
        gain, (state,) = dynamics_gain_stream(self.gain_op, [(self, cache)], energy, [state])
        return gain[:, None, :] * x, state

    def _composed_stream(self, energy, state, cache):
        """One block of :meth:`_composed_gain`: ``(N, block)`` input energy
        -> ``(gain, new state)``."""
        e_state, g_state = state["energy"], state["gain"]
        if self.energy_smoother_module is not None:
            energy, e_state = self.energy_smoother_module.stream(
                energy, e_state, z_alpha=cache.get("z_alpha_pre")
            )
        log_energy = torch.log(energy + 1e-5)
        log_gain = self.compute_gain(
            log_energy, cache["log_threshold"] - 6.0, cache["log_ratio"], cache.get("log_knee")
        )
        if self.gain_smoother_module is None:
            gain = torch.exp(log_gain)
        elif self.gain_smooth_in_log:
            smoothed, g_state = self.gain_smoother_module.stream(
                log_gain, g_state, z_alpha=cache.get("z_alpha_post")
            )
            gain = torch.exp(smoothed)
        else:
            gain, g_state = self.gain_smoother_module.stream(
                torch.exp(log_gain), g_state, z_alpha=cache.get("z_alpha_post")
            )
        return gain, {"energy": e_state, "gain": g_state}


    def compute_gain(self, log_energy, log_threshold, log_ratio, log_knee):
        match self.knee:
            case "hard":
                return self.gain_hard_knee(log_energy, log_threshold, log_ratio, None)
            case "quadratic":
                return self.gain_quad_knee(log_energy, log_threshold, log_ratio, log_knee)
            case "exponential":
                return self.gain_exp_knee(log_energy, log_threshold, log_ratio, log_knee)

    def parameter_size(self):
        size = {"log_threshold": 1, "log_ratio": 1}
        if self.knee != "hard":
            size["log_knee"] = 1
        if self.energy_smoother in ("iir", "iir_exact"):
            size["z_alpha_pre"] = 1
        elif self.energy_smoother == "ballistics":
            size["z_alpha_pre"] = 2
        if self.gain_smoother in ("iir", "iir_exact"):
            size["z_alpha_post"] = 1
        elif self.gain_smoother == "ballistics":
            size["z_alpha_post"] = 2
        return size

    @staticmethod
    def gain_hard_knee(log_energy, log_threshold, log_ratio, _):
        ratio = 1.0 + torch.exp(log_ratio)
        out = torch.minimum(
            log_energy, log_threshold + (log_energy - log_threshold) / ratio
        )
        return out - log_energy

    @staticmethod
    def gain_quad_knee(log_energy, log_threshold, log_ratio, log_knee):
        ratio = 1.0 + torch.exp(log_ratio)
        half_knee = torch.exp(log_knee) / 2.0
        below = log_energy
        above = log_threshold + (log_energy - log_threshold) / ratio
        middle = log_energy + (1.0 / ratio - 1.0) * torch.square(
            log_energy - log_threshold + half_knee
        ) / (4.0 * half_knee)
        out = torch.where(
            log_energy < log_threshold - half_knee,
            below,
            torch.where(log_energy > log_threshold + half_knee, above, middle),
        )
        return out - log_energy

    @staticmethod
    def gain_exp_knee(log_energy, log_threshold, log_ratio, log_knee):
        ratio = 1.0 + torch.exp(log_ratio)
        knee = torch.exp(log_knee)
        return (1.0 / ratio - 1.0) * F.softplus(knee * (log_energy - log_threshold)) / knee


class NoiseGate(Compressor):
    """Feed-forward noise gate: the below-threshold mirror of
    :class:`Compressor` (reference: dynamics.py:492-721)."""

    _fused_kind = "noisegate"

    @staticmethod
    def gain_hard_knee(log_energy, log_threshold, log_ratio, _):
        ratio = 1.0 + torch.exp(log_ratio)
        out = torch.minimum(
            log_energy, ratio * (log_energy - log_threshold) + log_threshold
        )
        return out - log_energy

    @staticmethod
    def gain_quad_knee(log_energy, log_threshold, log_ratio, log_knee):
        ratio = 1.0 + torch.exp(log_ratio)
        half_knee = torch.exp(log_knee) / 2.0
        below = ratio * (log_energy - log_threshold) + log_threshold
        above = log_energy
        middle = log_energy + (1.0 - ratio) * torch.square(
            log_energy - log_threshold - half_knee
        ) / (4.0 * half_knee)
        out = torch.where(
            log_energy < log_threshold - half_knee,
            below,
            torch.where(log_energy > log_threshold + half_knee, above, middle),
        )
        return out - log_energy

    @staticmethod
    def gain_exp_knee(log_energy, log_threshold, log_ratio, log_knee):
        one_minus_ratio = -torch.exp(log_ratio)
        knee = torch.exp(log_knee)
        return one_minus_ratio * F.softplus(knee * (log_threshold - log_energy)) / knee


class _FrameSmoother(nn.Module):
    """The envelope smoother of a :class:`FactorizedCompressor` off the
    frame gain op: the energy is mean-pooled into frames of ``frame_len``
    (the last one zero-padded on the right), smoothed by :class:`Ballistics`
    from ``zi = 1``, and interpolated back to the sample rate by a lerp
    between frame centres (:func:`~grafx_tpu_torch.ops.ballistics.
    frame_gain_core` computes the same, with the knee)."""

    def __init__(self, frame_len):
        super().__init__()
        self.frame_len = frame_len
        self.ballistics = Ballistics()

    def forward(self, energy, z_alpha):
        # the tracer's device interval of the pool, the walk and the lerp,
        # and the frames walked (rows x frames)
        with profiling.span("grafx.dynamics.frame", energy.device):
            s = self.ballistics(frame_means(energy, self.frame_len), z_alpha=z_alpha)
            profiling.count("ballistics.frame.frames", s.numel())
            return frame_lerp(s, self.frame_len, energy.shape[-1])



class FactorizedCompressor(Compressor):
    """Compressor with frame-factorized ballistics smoothing
    (:class:`grafx_tpu.processors.dynamics.FactorizedCompressor`; the
    reference ships a constructor-only stub, dynamics.py:724-739).

    The attack/release recursion runs over the ``ceil(L / frame_len)``
    frame means instead of the ``L`` samples, and the smoothed envelope is
    interpolated back to the sample rate: a small envelope lag for a
    ``frame_len``-times shorter serial walk.  Its smoother is not a
    per-sample walk, so it is no member of the walk ops; it has no compact
    stream state.  Its parameters are the ballistics :class:`Compressor`'s.

    With a quadratic knee and no gain smoother its gain is the frame gain
    op (:func:`gain_op`): pool, frame walk, lerp and knee in one forward
    and one adjoint.  Other configurations compose the frame smoother with
    the knee.
    """

    def __init__(self, frame_len=1024, gain_smoother=None, gain_smooth_in_log=False,
                 knee="quadratic", **backend_kwargs):
        super().__init__(
            energy_smoother="ballistics",
            gain_smoother=gain_smoother,
            gain_smooth_in_log=gain_smooth_in_log,
            knee=knee,
            **backend_kwargs,
        )
        self.frame_len = frame_len
        self.energy_smoother_module = _FrameSmoother(frame_len)

    def stream_init(self, num_channels, block_len, **params):
        raise NotImplementedError(
            "FactorizedCompressor has no compact per-sample state"
            " (frame-factorized smoothing); stream with"
            " Compressor(energy_smoother='ballistics') instead."
        )


class ApproxCompressor(nn.Module):
    """Deprecated v0.5 compressor: IIR envelope + quadratic knee
    (reference: dynamics.py:8-120)."""

    def __init__(self, iir_len=16384, **backend_kwargs):
        super().__init__()
        self.env_follower = IIREnvelopeFollower(iir_len=iir_len, **backend_kwargs)

    def forward(self, input_signals, z_alpha, log_threshold, log_ratio, log_knee=None):
        log_energy = self.env_follower(input_signals, z_alpha)
        log_gain = Compressor.gain_quad_knee(log_energy, log_threshold - 6.0, log_ratio, log_knee)
        return torch.exp(log_gain)[:, None, :] * input_signals

    def parameter_size(self):
        return {"z_alpha": 1, "log_threshold": 1, "log_ratio": 1, "log_knee": 1}


class ApproxNoiseGate(nn.Module):
    """Deprecated v0.5 noise gate (reference: dynamics.py:123-210)."""

    def __init__(self, freq_sample_n=16384, **backend_kwargs):
        super().__init__()
        self.env_follower = IIREnvelopeFollower(iir_len=freq_sample_n, **backend_kwargs)

    def forward(self, input_signals, z_alpha, log_threshold, log_ratio, log_knee):
        log_energy = self.env_follower(input_signals, z_alpha)
        return self.compute_gain(log_energy, log_threshold - 6.0, log_ratio, log_knee) * input_signals

    @staticmethod
    def compute_gain(log_energy, log_threshold, log_ratio, log_knee):
        ratio = torch.exp(log_ratio)
        knee = torch.exp(log_knee)
        below = ratio * (log_energy - log_threshold) + log_threshold
        above = log_energy
        middle = log_energy + (1.0 - ratio) * torch.square(
            log_energy - log_threshold - knee / 2.0
        ) / 2.0 / (knee + 1e-3)
        out = torch.where(
            log_energy < log_threshold - knee / 2.0,
            below,
            torch.where(log_energy > log_threshold + knee / 2.0, above, middle),
        )
        return torch.exp(out - log_energy)[:, None, :]

    def parameter_size(self):
        return {"z_alpha": 1, "log_threshold": 1, "log_ratio": 1, "log_knee": 1}


class BaseEnvelopeFollower(nn.Module):
    """Loudness detect (energy / amplitude / rms) -> smooth -> log
    (reference: dynamics.py:742-770)."""

    def __init__(self, smoother, detect_with="energy"):
        super().__init__()
        self.detect_with = detect_with
        self.smoother = smoother
        self.eps = 1e-7

    def forward(self, signal, *args, **kwargs):
        match self.detect_with:
            case "energy":
                loudness = torch.mean(torch.square(signal), dim=-2)
            case "amplitude":
                loudness = torch.mean(torch.abs(signal), dim=-2)
            case "rms_channel":
                loudness = torch.sqrt(self.eps + torch.mean(torch.square(signal), dim=-2))
            case _:
                raise ValueError(f"Unknown detect_with: {self.detect_with}")
        return torch.log(self.smoother(loudness, *args, **kwargs) + 1e-5)

    def parameter_size(self):
        # one coefficient for the one-pole smoother, two for ballistics (as
        # grafx_tpu resolves the reference's missing smoother method)
        return {"z_alpha": 2 if isinstance(self.smoother, Ballistics) else 1}


class IIREnvelopeFollower(BaseEnvelopeFollower):
    """Envelope follower with truncated one-pole smoothing
    (reference: dynamics.py:773-779)."""

    def __init__(self, detect_with="energy", iir_len=16384, **backend_kwargs):
        super().__init__(TruncatedOnePoleIIRFilter(iir_len=iir_len, **backend_kwargs),
                         detect_with=detect_with)

    def forward(self, signal, z_alpha):
        return super().forward(signal, z_alpha=z_alpha)


class BallisticsEnvelopeFollower(BaseEnvelopeFollower):
    """Envelope follower with ballistics smoothing
    (reference: dynamics.py:782-784)."""

    def __init__(self, detect_with="energy"):
        super().__init__(Ballistics(), detect_with=detect_with)

    def forward(self, signal, z_alpha):
        return super().forward(signal, z_alpha=z_alpha)
