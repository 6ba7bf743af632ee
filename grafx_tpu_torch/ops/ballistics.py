"""Fused ballistics smoothing + quadratic-knee gain, forward only.

The port of the primal (no-gradient) branches of
:func:`grafx_tpu.ops.ballistics.ballistics_gain_core` and
:func:`~grafx_tpu.ops.ballistics.ballistics_gain_pair_core`.  Each has two
implementations with one contract:

* a plain PyTorch version (``*_plain``): a loop over time, vectorized
  over rows.  The wrapper uses it for CPU tensors; it is also the
  reference the CUDA kernel is held against on the card;
* a CUDA kernel written for Hopper (``csrc/ballistics_gain.cu``), which
  the wrapper launches for CUDA tensors.  There is no fallback: a CUDA
  tensor reaches the kernel or the wrapper raises.

Each wrapper counts its kernel launches in its ``launches`` attribute.

The recursion, with per-row smoothing factors ``at`` (attack) and ``rt``
(release), is the select form

    y[n] = (u[n] > y[n-1]) ? (1 - at) y[n-1] + at u[n]
                           : (1 - rt) y[n-1] + rt u[n]

and the gain is ``exp(cf * f(log(y + 1e-5) - th))`` with ``f`` the
quadratic knee of ``grafx_tpu.ops.ballistics_tpu._knee_f``.  Gradients
come with the training kernels, in a later port.
"""

import torch

from grafx_tpu_torch.ops import _cuda

_EPS = 1e-5
_KINDS = {"compressor": 0, "noisegate": 1}


def fused_gain_available():
    """The fused gain path runs on every device: a kernel on CUDA, the
    plain version on the CPU."""
    return True


def _knee_f(x, hk, kind):
    if kind == "compressor":
        mid = torch.square(x + hk) / (4.0 * hk)
        return torch.where(x > hk, x, torch.where(x < -hk, 0.0, mid))
    mid = -torch.square(x - hk) / (4.0 * hk)
    return torch.where(x < -hk, x, torch.where(x > hk, 0.0, mid))


def _knee_gain(y, th, cf, hk, kind):
    x = torch.log(y + _EPS) - th[:, None]
    return torch.exp(cf[:, None] * _knee_f(x, hk[:, None], kind))


def _walk(u, y0, at, rt):
    """The ballistics recursion over ``(N, L)`` from ``(N,)`` states."""
    oma, omr = 1.0 - at, 1.0 - rt
    au, ru = at[:, None] * u, rt[:, None] * u
    y = torch.empty_like(u)
    st = y0
    for n in range(u.shape[1]):
        up = torch.addcmul(au[:, n], oma, st)
        dn = torch.addcmul(ru[:, n], omr, st)
        st = torch.where(u[:, n] > st, up, dn)
        y[:, n] = st
    return y


def ballistics_gain_plain(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Plain version of :func:`ballistics_gain_core` (any device)."""
    return _knee_gain(_walk(u, zi, at, rt), th, cf, hk, kind)


def ballistics_gain_pair_plain(
    u, at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"), inits=(1.0, 1.0),
):
    """Plain version of :func:`ballistics_gain_pair_core` (any device)."""
    init_a = torch.full_like(at_a, inits[0])
    init_b = torch.full_like(at_b, inits[1])
    ga = _knee_gain(_walk(u, init_a, at_a, rt_a), th_a, cf_a, hk_a, kinds[0])
    ec = ga * ga * u
    gb = _knee_gain(_walk(ec, init_b, at_b, rt_b), th_b, cf_b, hk_b, kinds[1])
    return ga * gb


def _launch_args(u, consts, name):
    """Validate a kernel's inputs; returns ``(u, consts (k, N), out)``."""
    if u.dtype != torch.float32 or u.dim() != 2:
        raise ValueError(f"{name}: u must be a float32 (N, L) tensor, got {u.dtype} {tuple(u.shape)}")
    if torch.is_grad_enabled() and (
        u.requires_grad or any(c.requires_grad for c in consts)
    ):
        raise NotImplementedError(
            f"{name}: the CUDA path is forward-only; the gradient kernels"
            " are not ported yet."
        )
    n = u.shape[0]
    for c in consts:
        if c.shape != (n,) or c.device != u.device or c.dtype != torch.float32:
            raise ValueError(f"{name}: every constant must be a float32 ({n},) tensor on {u.device}")
    return u.contiguous(), torch.stack(consts).contiguous(), torch.empty_like(u, memory_format=torch.contiguous_format)


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def ballistics_gain_core(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Ballistics smoothing + quadratic-knee gain in one call.

    Replaces ``_fwd_gain_only_kernel`` (grafx_tpu/ops/ballistics_tpu.py).

    Args:
        u: ``(N, L)`` energy envelopes.
        zi, at, rt: ``(N,)`` initial state and smoothing factors.
        th: ``(N,)`` log-threshold (already shifted by -6).
        cf: ``(N,)`` knee coefficient (``1/ratio - 1`` for compressors,
            ``ratio - 1`` for gates).
        hk: ``(N,)`` half-knee ``exp(log_knee) / 2``.
        kind: ``"compressor"`` or ``"noisegate"``.

    Returns:
        ``(N, L)`` gains.
    """
    if u.device.type == "cpu":
        return ballistics_gain_plain(u, zi, at, rt, th, cf, hk, kind)
    if u.device.type != "cuda":
        raise ValueError(f"ballistics_gain_core: unsupported device {u.device}")
    u, consts, out = _launch_args(u, (zi, at, rt, th, cf, hk), "ballistics_gain_core")
    rc = _cuda.library().grafx_gain_fwd(
        u.data_ptr(), out.data_ptr(), consts.data_ptr(), u.shape[0], u.shape[1],
        _KINDS[kind], u.device.index, torch.cuda.current_stream(u.device).cuda_stream,
    )
    _check(rc, "ballistics_gain_core")
    ballistics_gain_core.launches += 1
    return out


ballistics_gain_core.launches = 0


def ballistics_gain_pair_core(
    u,
    at_a, rt_a, th_a, cf_a, hk_a,
    at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"),
    inits=(1.0, 1.0),
):
    """Two chained smoother + knee gain stages in one call:
    ``g_a * g_b`` with ``g_a`` the first stage's gain on ``u`` (initial
    state ``inits[0]``) and ``g_b`` the second stage's gain on the gated
    energy ``g_a^2 u``.

    Replaces ``_fwd_gain_pair_only_kernel``
    (grafx_tpu/ops/ballistics_tpu.py).

    Args:
        u: ``(N, L)`` input energy envelopes.
        at_a..hk_a, at_b..hk_b: ``(N,)`` per-stage constants; an exact
            one-pole stage is ``at == rt == 1 - alpha`` with init 0.0.
        kinds: pair of ``"compressor"``/``"noisegate"``.
        inits: per-stage initial envelope (1.0 ballistics, 0.0 one-pole).

    Returns:
        ``(N, L)`` combined gains.
    """
    consts = (at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b)
    if u.device.type == "cpu":
        return ballistics_gain_pair_plain(u, *consts, kinds=kinds, inits=inits)
    if u.device.type != "cuda":
        raise ValueError(f"ballistics_gain_pair_core: unsupported device {u.device}")
    u, consts, out = _launch_args(u, consts, "ballistics_gain_pair_core")
    scratch = torch.empty_like(out)
    rc = _cuda.library().grafx_gain_pair_fwd(
        u.data_ptr(), out.data_ptr(), scratch.data_ptr(), consts.data_ptr(),
        u.shape[0], u.shape[1],
        _KINDS[kinds[0]], _KINDS[kinds[1]], float(inits[0]), float(inits[1]),
        u.device.index, torch.cuda.current_stream(u.device).cuda_stream,
    )
    _check(rc, "ballistics_gain_pair_core")
    ballistics_gain_pair_core.launches += 1
    return out


ballistics_gain_pair_core.launches = 0
