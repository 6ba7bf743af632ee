"""Dynamics processors: compressors, noise gates and envelope followers
(the port of :mod:`grafx_tpu.processors.dynamics`; reference:
src/grafx/processors/dynamics.py:8-784).

With a quadratic knee, no gain smoother and a ballistics or exact
one-pole energy smoother, the gain runs as one fused smoother + knee op
(:func:`grafx_tpu_torch.ops.ballistics.ballistics_gain_core`): a CUDA
kernel on the card, its plain version on the CPU.  A one-pole smoother
is the ``at == rt == 1 - alpha`` case of that recursion with initial
state 0, and its trailing relu is a no-op on nonnegative energy.  Other
configurations compose the smoother (:mod:`~grafx_tpu_torch.processors.
core.envelope`) with the knee math, forward and under gradient.  A
:class:`FactorizedCompressor` with a quadratic knee and no gain smoother
runs its pool, frame walk, lerp and knee as one op
(:func:`~grafx_tpu_torch.ops.ballistics.frame_gain_core`); other ones
compose its frame smoother, which walks the frame means with the plain
ballistics walk (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_core`),
with the knee.

A compressor or gate that smooths its gain with ballistics (and has a
quadratic knee and a ballistics or exact one-pole energy smoother) runs
its energy walk, knee and gain walk as one dynamics chain op
(:func:`grafx_tpu_torch.ops.ballistics.ballistics_chain_core`, the port's
own kernel), forward, under gradient and streamed: the chain returns
every walk's final state.  :func:`dynamics_chain_spec` decides from the
configuration alone, once per processor, whether a run takes it;
:func:`dynamics_chain` builds its operands only then.

Other streams (``stream_init`` / ``stream_step``) compose, as
``grafx_tpu`` does: the fused gain kernels do not return the final
envelope a stream carries into its next block.
"""

import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch import profiling
from grafx_tpu_torch.ops.ballistics import (
    ballistics_chain_core,
    ballistics_chain_stream,
    ballistics_gain_core,
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


def smoother_recursion(smoother, z_alpha):
    """``(at, rt, init)`` of the ballistics recursion equal to
    ``smoother`` with pre-sigmoid coefficients ``z_alpha``, or ``None``
    when the smoother is not one (shared with
    ``render.fuse.FusedDynamicsChain``)."""
    if isinstance(smoother, Ballistics):
        ts = torch.sigmoid(z_alpha)
        return ts[..., 0], ts[..., 1], 1.0
    if isinstance(smoother, TruncatedOnePoleIIRFilter) and smoother.exact:
        alpha = torch.clamp(torch.sigmoid(z_alpha[..., 0]), max=1.0 - 1e-5)
        return 1.0 - alpha, 1.0 - alpha, 0.0
    return None


def dynamics_chain_spec(procs):
    """The dynamics chain op's spec for a run of ``procs`` (one or two,
    in order), decided from their configurations alone: each member's
    :attr:`Compressor.chain_member`, or ``None`` where a member does not
    qualify or none smooths its gain (the fused gain ops serve those
    runs).  Shared with ``render.fuse.FusedDynamicsChain``."""
    if not 1 <= len(procs) <= 2:
        return None
    spec = tuple(getattr(proc, "chain_member", None) for proc in procs)
    if None in spec or all(smooth is None for _, smooth in spec):
        return None
    return spec


def dynamics_chain(spec, members, present=None):
    """The operands of the dynamics chain op for a run of ``members``,
    ``[(processor, params)]`` of spec ``spec`` (:func:`dynamics_chain_spec`;
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
        #: the dynamics chain op's spec of this processor alone, or None
        self.chain_spec = dynamics_chain_spec([self])

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

    @property
    def chain_member(self):
        """``(kind, smooth)`` of this processor in a walk op, from its
        configuration alone: ``smooth`` is ``None`` without a gain
        smoother (the fused gain ops' members), else ``"log"`` or
        ``"linear"`` (the dynamics chain's); ``None`` unless the knee is
        quadratic, the energy smoother a ballistics or exact one-pole
        recursion (:func:`smoother_recursion`) and the gain smoother, if
        any, ballistics (a one-pole gain smoother ends in a relu, which
        the walk lacks, and a log gain is negative)."""
        energy, gain = self.energy_smoother_module, self.gain_smoother_module
        exact = isinstance(energy, TruncatedOnePoleIIRFilter) and energy.exact
        if self.knee != "quadratic" or not (exact or isinstance(energy, Ballistics)):
            return None
        if gain is None:
            return self._fused_kind, None
        if not isinstance(gain, Ballistics):
            return None
        return self._fused_kind, "log" if self.gain_smooth_in_log else "linear"

    def fused_recursion(self, z_alpha_pre):
        """``(at, rt, init)`` when the gain can run as the fused smoother
        + knee op, else ``None``."""
        if self.chain_member is None or self.chain_member[1] is not None:
            return None
        return smoother_recursion(self.energy_smoother_module, z_alpha_pre)

    def knee_constants(self, log_threshold, log_ratio, log_knee):
        """``(th, cf, hk)`` of the fused op: shifted threshold, knee
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
        """Linear gain time series from the ``(N, L)`` input energy."""
        if self.chain_spec is not None:
            params = dict(log_threshold=log_threshold, log_ratio=log_ratio, log_knee=log_knee,
                          z_alpha_pre=z_alpha_pre, z_alpha_post=z_alpha_post)
            consts, inits = dynamics_chain(self.chain_spec, [(self, params)])
            return ballistics_chain_core(energy, consts, request_states(consts, inits), self.chain_spec)[0]
        rec = self.fused_recursion(z_alpha_pre)
        if rec is not None:
            at, rt, init = rec
            th, cf, hk = self.knee_constants(log_threshold, log_ratio, log_knee)
            zi = torch.full_like(at, init)
            return ballistics_gain_core(energy, zi, at, rt, th, cf, hk, self._fused_kind)
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
        gain, state = self.gain_stream_from_energy(energy, state, cache)
        return gain[:, None, :] * x, state

    def gain_stream_from_energy(self, energy, state, cache):
        """Streaming counterpart of :meth:`gain_from_energy`: one block of
        ``(N, block)`` input energy -> ``(gain, new state)``."""
        spec = self.chain_spec
        if spec is not None:
            consts, _ = dynamics_chain(spec, [(self, cache)])
            gain, new = ballistics_chain_stream(energy, consts, chain_states(spec, [state]), spec)
            return gain, member_states(spec, new, [state])[0]
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
    per-sample walk, so the gain never takes the fused smoother + knee op
    (``fused_recursion`` is ``None``); it has no compact stream state.
    Its parameters are the ballistics :class:`Compressor`'s.

    With a quadratic knee and no gain smoother (:attr:`frame_fused`,
    decided from the configuration) the gain is one op,
    :func:`~grafx_tpu_torch.ops.ballistics.frame_gain_core`: pool, frame
    walk, lerp and knee in one forward and one adjoint.  Other
    configurations compose the frame smoother with the knee.
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
        self.chain_spec = dynamics_chain_spec([self])  # None: not a per-sample walk
        #: the gain runs as the frame gain op
        self.frame_fused = knee == "quadratic" and gain_smoother is None

    def gain_from_energy(
        self,
        energy,
        log_threshold,
        log_ratio,
        log_knee=None,
        z_alpha_pre=None,
        z_alpha_post=None,
    ):
        if not self.frame_fused:
            return super().gain_from_energy(energy, log_threshold, log_ratio, log_knee=log_knee,
                                            z_alpha_pre=z_alpha_pre, z_alpha_post=z_alpha_post)
        # the tracer's device interval of the pool, the walk, the lerp and
        # the knee, and the frames walked (rows x frames), all by the op
        with profiling.span("grafx.dynamics.frame", energy.device):
            ts = torch.sigmoid(z_alpha_pre)
            th, cf, hk = self.knee_constants(log_threshold, log_ratio, log_knee)
            gain = frame_gain_core(energy, ts[..., 0], ts[..., 1], th, cf, hk, self.frame_len)
            frames = energy.shape[0] * -(-energy.shape[-1] // self.frame_len)
            profiling.count("ballistics.frame.frames", frames)
            profiling.count("ballistics.frame.fused", frames)
            return gain

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
