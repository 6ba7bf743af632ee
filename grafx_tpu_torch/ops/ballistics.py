"""Ballistics smoothing, alone and fused with a quadratic-knee gain.

The port of :func:`grafx_tpu.ops.ballistics.ballistics_core`,
:func:`~grafx_tpu.ops.ballistics.ballistics_gain_core` and
:func:`~grafx_tpu.ops.ballistics.ballistics_gain_pair_core` with their
``custom_vjp``s, and of the reverse scan ``reverse_scan_pallas``: ten
kernels; the dynamics chain, the port's own kernel for a gain-smoothed
dynamics run; and the frame gain, the port's own op for a
``FactorizedCompressor`` (both below).  Each has two implementations of
one contract:

* a plain PyTorch version (``*_plain``): loops over time, vectorized
  over rows.  The wrapper uses it for CPU tensors; it is also the
  reference the CUDA kernel is held against on the card;
* a CUDA kernel written for Hopper (``csrc/ballistics_gain.cu`` for the
  forwards, ``csrc/ballistics_grad.cu`` for the adjoints), which the
  wrapper launches for CUDA tensors.  There is no fallback: a CUDA
  tensor reaches the kernel or the wrapper raises.

Five op families, one definition each: the pair (#1, #3, #4), the gain
(#2, #5, #6), the walk (#7-#9, and the reverse scan #10 beside it), the
chain and the frame gain.  A family is its plain versions, its CUDA
launchers (``_*_fwd_cuda`` and the body of its adjoint) and its operands;
the rest is written once: the CPU / CUDA split of every wrapper
(:func:`_kernel`), one operand check (:func:`_operand`), the primal's
custom op and its grad / no-grad dispatch (:func:`_core`), its autograd
Function (:class:`_Adjoint`) and the launch count (:func:`_run`), which
counts every kernel launch for :func:`launch_counts` (the eager and
capturing calls of a compiled path, not its replays) and, with tracing
on (:func:`grafx_tpu_torch.profiling.tracing`), in the report, replays
too.

=====================================  ==================================
wrapper                                replaces (grafx_tpu/ops/ballistics_tpu.py)
=====================================  ==================================
:func:`ballistics_gain_pair_core`      ``_fwd_gain_pair_only_kernel`` (no grad)
:func:`ballistics_gain_core`           ``_fwd_gain_only_kernel`` (no grad)
:func:`ballistics_gain_pair_fwd`       ``_fwd_gain_pair_kernel``
:func:`ballistics_gain_pair_bwd`       ``_bwd_gain_pair_kernel``
:func:`ballistics_gain_fwd`            ``_fwd_gain_kernel``
:func:`ballistics_gain_bwd`            ``_bwd_gain_kernel``
:func:`ballistics_core`                ``_kernel`` (no grad)
:func:`ballistics_fwd`                 ``_fwd_d_kernel``
:func:`ballistics_bwd`                 ``_bwd_fused_kernel``
:func:`reverse_scan`                   ``_bwd_kernel``
:func:`ballistics_chain_core`          none: grafx_tpu composes the walks (no grad)
:func:`ballistics_chain_fwd`           none (the chain with residuals)
:func:`ballistics_chain_bwd`           none (its adjoint)
:func:`frame_gain_core`                none: grafx_tpu composes ``_FrameSmoother`` and the knee (no grad)
:func:`frame_gain_fwd`                 none (the frame gain with residuals)
:func:`frame_gain_bwd`                 none (its adjoint)
=====================================  ==================================

The cores dispatch as the JAX ones do: with grad enabled and any
input requiring grad they run a ``torch.autograd.Function`` whose
forward saves the JAX residuals (``d = u - y[n-1]``, and for the gains
the final state) and whose backward is the adjoint kernel; otherwise
the primal-only kernel.  :func:`reverse_scan` has no caller in the
package, as ``reverse_scan_pallas`` has none in ``grafx_tpu``.

The recursion, with per-row smoothing factors ``at`` (attack) and ``rt``
(release), is the select form

    y[n] = (u[n] > y[n-1]) ? (1 - at) y[n-1] + at u[n]
                           : (1 - rt) y[n-1] + rt u[n]

and the gain is ``exp(cf * f(log(y + 1e-5) - th))`` with ``f`` the
quadratic knee of ``grafx_tpu.ops.ballistics_tpu._knee_f``.  Gradients
treat the attack/release decisions (``d > 0``) as constants.  The
adjoint rebuilds ``y`` from ``u - d`` shifted one sample (``y[L-1]`` is
the saved final state) and walks ``gh[n] = g[n] + (1 - c[n+1]) gh[n+1]``
back in time.  Per-row parameter sums are taken per 32-sample tile and
then over the tiles, as the Pallas kernels sum each tile.  On the card
the adjoints split that linear walk over time chunks
(:func:`walk_chunk`; :func:`_reverse_walk_chunked` is the same
decomposition in PyTorch, for the tests).

The forward walks cannot be split so: one thread walks a row from its
first sample to its last.  With ``at, rt`` in [0, 1] the step is an
envelope of its two affine pieces: ``max(oma s + at u, omr s + rt u)``
(``oma = 1 - at``, ``omr = 1 - rt``) where ``at >= rt``, ``min`` where
``at < rt``, which is the select form in real arithmetic (the pieces
differ by ``(at - rt)(u - s)``).  A row's orientation is taken once:
its walk runs on ``sgn u`` from ``sgn y0`` with ``max``, ``sgn = +1``
or ``-1``, and ``sgn`` times that walk is the row's.  ``k`` such steps
compose into ``k + 1`` affine pieces, slopes ``oma^i omr^(k-i)`` and
offsets that depend on the input alone (:func:`_link_pieces`), so the
serial chain advances a *link* of ``k`` = :data:`WALK_LINK` samples at a
time, from the row's first sample: ``k + 1`` FMAs from the state and
their max.  A link's inner samples are single steps from its entering
state; a row's last ``L mod k`` samples walk single steps.  A flat link
(its ``k`` samples equal, ``v``) takes the offsets ``v - c_i v``, which
map ``v`` to itself exactly, so a walk that meets a constant input (a
static gain of 1) stays on it, as the select form does.  Elsewhere the
roundings differ from the select form's (the composed slopes and offsets
are rounded once each; near ``u == s`` the other piece, equal to an ulp
or two, may win), by a few ulps of the row's scale where ``rt >= 0.01``
and by more as the release slows, as the select form's own distance from
the recursion in exact arithmetic grows (``tests/test_torch_ballistics.py``
bounds both).  A stream that ends a call inside a link carries the link's
entering state and its samples so far, and the next call walks them again
(:func:`ballistics_stream`, :func:`ballistics_chain_stream`), so that a
row split anywhere equals one call bit for bit.  On the card a block walks one row, staged
through shared memory T samples at a time by bulk copies, and the pair's
two members walk in one kernel, member b a stage behind member a
(:func:`walk_samples` picks T; ``csrc/ballistics_gain.cu`` has the
design).

The dynamics chain (:func:`ballistics_chain_core`) is a compressor or
gate that smooths its gain with ballistics, or a gate -> compressor run
of one or two such members: per member an energy walk, the knee, and a
gain walk, the members' gains multiplied, each member walking the energy
gated by the ones before it.  ``grafx_tpu`` runs each of those walks as
its own ``ballistics_core`` call with the knees between them; the port
walks them all in one kernel, each walk a stage behind the one before
(``csrc/ballistics_gain.cu``, ``chain_kernel``), and its adjoint walks
them back in time chunks with the knee adjoints between
(``csrc/ballistics_grad.cu``, ``grafx_chain_bwd``).

The frame gain (:func:`frame_gain_core`) is a ``FactorizedCompressor``'s
whole gain from its energy: the mean over frames of ``frame_len``
samples, the ballistics walk over the frame means from 1, the lerp back
to the sample rate and the quadratic knee.  ``grafx_tpu`` runs each of
those as its own pass over the samples (and again under the gradient);
the port runs them as three launches forward and three for the adjoint,
which read and write each ``(N, L)`` array once and keep only the frame
walk's ``(N, F)`` residuals (``csrc/frame_gain.cu`` has the design).

Each family's primal (#1, #2, #7, the chain's and the frame gain's),
which a served render and a stream block launch, is a ``torch.library``
custom op (``torch.ops.grafx_tpu_torch.ballistics_gain_pair``,
``.ballistics_gain``, ``.ballistics``, ``.ballistics_chain`` and
``.frame_gain``): the CPU implementation is the plain version, the CUDA
one the kernel's launch, and a fake implementation gives the output's
shape.  ``torch.export`` so records one op where it would otherwise
unroll the plain version's loop over time, and could not see a ctypes
call.
"""

import ctypes
import functools
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from grafx_tpu_torch import profiling
from grafx_tpu_torch.ops import _cuda

_EPS = 1e-5
_TILE = 32
_KINDS = {"compressor": 0, "noisegate": 1}
_MIN_CHUNK = 64
_STAGE = 1024  # the most samples a stage of the forward walks holds
# the samples a link of the forward walks' serial chain covers; the kernels'
# kLink (csrc/ballistics.cuh)
WALK_LINK = 8


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _knee_f(x, hk, kind):
    if kind == "compressor":
        mid = torch.square(x + hk) / (4.0 * hk)
        return torch.where(x > hk, x, torch.where(x < -hk, 0.0, mid))
    mid = -torch.square(x - hk) / (4.0 * hk)
    return torch.where(x < -hk, x, torch.where(x > hk, 0.0, mid))


def _knee_fp(x, hk, kind):
    """df/dx."""
    if kind == "compressor":
        mid = (x + hk) / (2.0 * hk)
        return torch.where(x > hk, 1.0, torch.where(x < -hk, 0.0, mid))
    mid = -(x - hk) / (2.0 * hk)
    return torch.where(x < -hk, 1.0, torch.where(x > hk, 0.0, mid))


def _knee_fhk(x, hk, kind):
    """df/dhk (nonzero only in the knee region)."""
    inside = (x >= -hk) & (x <= hk)
    if kind == "compressor":
        mid = (x + hk) * (hk - x) / (4.0 * hk * hk)
    else:
        mid = (x - hk) * (x + hk) / (4.0 * hk * hk)
    return torch.where(inside, mid, 0.0)


def _knee_gain(y, th, cf, hk, kind):
    x = torch.log(y + _EPS) - th[:, None]
    return torch.exp(cf[:, None] * _knee_f(x, hk[:, None], kind))


def _link_slopes(oma, omr, k):
    """``(k + 1, N)``: slope ``i`` of a link's pieces, ``oma^i omr^(k-i)``,
    each power by repeated products and then their product, as the
    kernels round it."""
    pa, pr = [torch.ones_like(oma)], [torch.ones_like(omr)]
    for _ in range(k):
        pa.append(pa[-1] * oma)
        pr.append(pr[-1] * omr)
    return torch.stack([pa[i] * pr[k - i] for i in range(k + 1)])


def _link_pieces(au, ru, oma, omr):
    """The offsets of a link's pieces, ``(k + 1, ...)`` from the ``(...,
    k)`` products ``at u`` and ``rt u`` of its oriented samples: offset
    ``i`` is the largest over the step sequences with ``i`` attack steps,
    built one step at a time (``oma``, ``omr`` broadcast against
    ``au[..., 0]``)."""
    k = au.shape[-1]
    o = [ru[..., 0], au[..., 0]]
    for j in range(1, k):
        a, r = au[..., j], ru[..., j]
        inner = [
            torch.maximum(torch.addcmul(a, oma, o[i - 1]), torch.addcmul(r, omr, o[i]))
            for i in range(1, j + 1)
        ]
        o = [torch.addcmul(r, omr, o[0]), *inner, torch.addcmul(a, oma, o[j])]
    return torch.stack(o)


def _select_walk(u, y0, at, rt):
    """The recursion in its select form, sample by sample: the definition
    the links are held to, and under autograd the plain walk's derivative
    (the attack/release decisions held constant)."""
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


def _walk(u, y0, at, rt):
    """The ballistics recursion over ``(N, L)`` from ``(N,)`` states, in
    links of :data:`WALK_LINK` samples: the forward kernels' arithmetic.  Under
    autograd its gradient is the select form's: the links' max would
    split the gradient between pieces that tie (all of them where ``at ==
    rt``), where the recursion holds each decision constant."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, y0, at, rt)):
        return _PlainWalk.apply(u, y0, at, rt)
    return _link_walk(u, y0, at, rt)


class _PlainWalk(torch.autograd.Function):
    """The links forward, the select form's autograd backward."""

    @staticmethod
    def forward(ctx, u, y0, at, rt):
        ctx.save_for_backward(u, y0, at, rt)
        return _link_walk(u, y0, at, rt)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(_select_walk(*leaves), wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def _link_walk(u, y0, at, rt):
    """:func:`_walk` without autograd (module docstring)."""
    n, length, link = *u.shape, WALK_LINK
    sgn = torch.where(at >= rt, 1.0, -1.0).to(u.dtype)
    oma, omr = (1.0 - at)[:, None], (1.0 - rt)[:, None]
    uo = sgn[:, None] * u
    au, ru = at[:, None] * uo, rt[:, None] * uo
    links, y = length // link, torch.empty_like(u)
    st = sgn * y0
    if links:
        span = links * link
        au_l, ru_l = au[:, :span].reshape(n, links, link), ru[:, :span].reshape(n, links, link)
        # (links, k + 1, N): a link's offsets together for the serial loop
        slopes = _link_slopes(oma[:, 0], omr[:, 0], link)
        pieces = _link_pieces(au_l, ru_l, oma, omr)
        uo_l = uo[:, :span].reshape(n, links, link)
        v = uo_l[..., 0]
        flat = (uo_l == v[..., None]).all(-1)  # a flat link maps its value to itself
        pieces = torch.where(flat, torch.addcmul(v, -slopes[..., None], v), pieces)
        pieces = pieces.permute(2, 0, 1).contiguous()
        ends = torch.empty(links, n, dtype=u.dtype, device=u.device)
        for i in range(links):
            st = torch.addcmul(pieces[i], slopes, st).amax(0)
            ends[i] = st
        ends = ends.T
        yl = y[:, :span].view(n, links, link)
        prev = torch.cat([(sgn * y0)[:, None], ends[:, :-1]], dim=1)
        for m in range(link - 1):  # a link's inner samples from its entering state
            prev = torch.maximum(torch.addcmul(au_l[..., m], oma, prev),
                                 torch.addcmul(ru_l[..., m], omr, prev))
            yl[..., m] = prev
        yl[..., link - 1] = ends
    for j in range(links * link, length):  # the ragged tail: single steps
        st = torch.maximum(torch.addcmul(au[:, j], oma[:, 0], st),
                           torch.addcmul(ru[:, j], omr[:, 0], st))
        y[:, j] = st
    return sgn[:, None] * y


def _residual(u, y, y0):
    """``d[n] = u[n] - y[n-1]`` (``y[-1] = y0``)."""
    return u - torch.cat([y0[:, None], y[:, :-1]], dim=1)


def _rebuild(ud, last):
    """``y[n] = (u - d)[n+1]``, with ``y[L-1]`` the saved final state."""
    return torch.cat([ud[:, 1:], last[:, None]], dim=1)


def _tile_sum(x):
    """Per-row sum over time: per 32-sample tile, then over the tiles."""
    n, length = x.shape
    x = F.pad(x, (0, -length % _TILE))
    return x.reshape(n, -1, _TILE).sum(-1).sum(-1)


def _reverse_walk(g, d, at, rt):
    """The adjoint recursion ``gh[n] = g[n] + (1 - c[n+1]) gh[n+1]``
    with ``c = at`` where ``d > 0`` (attack) else ``rt``.

    Returns ``(c gh, dat, drt, dzi)``: the input cotangent, the tile sums
    of ``d gh`` over attack and release samples, and ``(1 - c[0]) gh[0]``.
    """
    att = d > 0
    c = torch.where(att, at[:, None], rt[:, None])
    omc = 1.0 - c
    gh = torch.empty_like(g)
    st = torch.zeros_like(at)
    a = torch.zeros_like(at)
    for n in range(g.shape[1] - 1, -1, -1):
        st = torch.addcmul(g[:, n], a, st)
        gh[:, n] = st
        a = omc[:, n]
    dc = d * gh
    dat = _tile_sum(torch.where(att, dc, 0.0))
    drt = _tile_sum(torch.where(att, 0.0, dc))
    return c * gh, dat, drt, omc[:, 0] * gh[:, 0]


def walk_chunk(n, length, chunk=None, slots=None):
    """The chunk length, in samples, of the CUDA reverse walk over ``(n,
    length)`` rows: ``chunk`` if given (a positive multiple of 32); else,
    for ``slots`` virtual rows resident on the card at once
    (:func:`walk_slots`), the shortest multiple of 32, at least 64, whose
    ``n x chunks`` virtual rows all fit, a row of at most two such chunks
    walked whole; with neither, the whole row.  Never more than the row's
    tiles.
    """
    tiles = max(1, -(-length // _TILE))
    if chunk is None:
        chunk = tiles * _TILE
        if slots is not None:
            per_row = max(1, slots // max(n, 1))
            split = max(_MIN_CHUNK, -(-tiles // per_row) * _TILE)
            if length > 2 * split:
                chunk = split
    elif isinstance(chunk, bool) or not isinstance(chunk, int) or chunk <= 0 or chunk % _TILE:
        raise ValueError(f"chunk must be a positive multiple of {_TILE}, got {chunk!r}")
    return min(chunk, tiles * _TILE)


def walk_samples(length, samples=None):
    """The samples T a stage of the CUDA forward walks holds, over rows of
    ``length`` samples: ``samples`` if given (a positive multiple of 32,
    at most 1024); else 1024, or the row's length rounded up to 32 where
    that is less.  A block walks one row through a ring of such stages.
    """
    if samples is None:
        return min(_STAGE, max(1, -(-length // _TILE)) * _TILE)
    if (isinstance(samples, bool) or not isinstance(samples, int) or samples <= 0
            or samples % _TILE or samples > _STAGE):
        raise ValueError(
            f"samples must be a positive multiple of {_TILE} up to {_STAGE}, got {samples!r}"
        )
    return samples


def walk_slots(device):
    """The virtual rows (row, chunk) the CUDA reverse walk holds resident
    at once on the CUDA ``device``: its SMs x the walk kernel's one-warp
    blocks an SM (its occupancy, from the compiled kernel) x 32 lanes."""
    device = torch.device(device)
    return _walk_slots(torch.cuda.current_device() if device.index is None else device.index)


@functools.cache
def _walk_slots(index):
    blocks = ctypes.c_int(0)
    rc = _cuda.library().grafx_walk_blocks_per_sm(ctypes.byref(blocks), index)
    if rc != 0:
        raise RuntimeError(f"walk_slots: occupancy query failed with cudaError {rc}")
    return torch.cuda.get_device_properties(index).multi_processor_count * blocks.value * _TILE


def _reverse_walk_chunked(g, d, at, rt, chunk):
    """:func:`_reverse_walk` as the CUDA kernels decompose it over chunks of
    ``chunk`` samples (:func:`walk_chunk` validates and clamps it), in
    three passes vectorized over (row, chunk):

    1. each chunk walks from ``gh = 0``, keeping its ``gh`` at its first
       sample and the product of its carry factors ``1 - c[m]``, m from its
       second sample through the next chunk's first;
    2. from the last chunk back, ``gh`` entering each chunk from its end:
       ``x[k-1] = local[k] + prod[k] x[k]``, ``x[C-1] = 0``;
    3. each chunk walks again from its ``x``.

    Samples past L are zeros, so nothing flows from them.  One chunk is
    :func:`_reverse_walk` bit for bit.  Used by the tests only.
    """
    n, length = g.shape
    chunk = walk_chunk(n, length, chunk)
    chunks = -(-length // chunk)
    pad = chunks * chunk - length
    att = d > 0
    c = torch.where(att, at[:, None], rt[:, None])
    omc = 1.0 - c
    gp = F.pad(g, (0, pad)).reshape(n, chunks, chunk)
    om = F.pad(omc, (0, pad)).reshape(n, chunks, chunk)
    # the factor entering each chunk from its end: 1 - c at the next chunk's start
    om_in = torch.cat([om[:, 1:, 0], torch.zeros_like(om[:, :1, 0])], dim=1)

    def walk(seed):
        gh = torch.empty_like(gp)
        st, a, prod = seed, om_in, torch.ones_like(seed)
        for j in range(chunk - 1, -1, -1):
            st = torch.addcmul(gp[:, :, j], a, st)
            gh[:, :, j] = st
            prod = prod * a
            a = om[:, :, j]
        return gh, prod

    local, prod = walk(torch.zeros_like(om_in))
    x = torch.empty_like(om_in)
    st = torch.zeros_like(at)
    for k in range(chunks - 1, -1, -1):
        x[:, k] = st
        st = torch.addcmul(local[:, k, 0], prod[:, k], st)
    gh = walk(x)[0].reshape(n, -1)[:, :length]
    dc = d * gh
    dat = _tile_sum(torch.where(att, dc, 0.0))
    drt = _tile_sum(torch.where(att, 0.0, dc))
    return c * gh, dat, drt, omc[:, 0] * gh[:, 0]


def _reverse_scan_chunked(a, g, chunk):
    """:func:`reverse_scan_plain` as the CUDA kernel decomposes it over
    chunks of ``chunk`` samples (:func:`walk_chunk` validates and clamps
    it): each chunk walks from ``gh = 0`` keeping its ``gh`` at its first
    sample and the product of its ``a``; from the last chunk back, ``gh``
    entering chunk k is ``x[k-1] = local[k] + prod[k] x[k]``, ``x[C-1] =
    0``; each chunk walks again from its ``x``.  One chunk is
    :func:`reverse_scan_plain` bit for bit.  Used by the tests only."""
    n, length = g.shape
    chunk = walk_chunk(n, length, chunk)
    chunks = -(-length // chunk)
    pad = chunks * chunk - length
    ap = F.pad(a, (0, pad)).reshape(n, chunks, chunk)
    gp = F.pad(g, (0, pad)).reshape(n, chunks, chunk)

    def walk(seed):
        gh = torch.empty_like(gp)
        st, prod = seed, torch.ones_like(seed)
        for j in range(chunk - 1, -1, -1):
            st = torch.addcmul(gp[:, :, j], ap[:, :, j], st)
            gh[:, :, j] = st
            prod = prod * ap[:, :, j]
        return gh, prod

    local, prod = walk(gp.new_zeros(n, chunks))
    x = torch.empty_like(prod)
    st = g.new_zeros(n)
    for k in range(chunks - 1, -1, -1):
        x[:, k] = st
        st = torch.addcmul(local[:, k, 0], prod[:, k], st)
    return walk(x)[0].reshape(n, -1)[:, :length]


def _knee_terms(y, th, hk, kind):
    x = torch.log(y + _EPS) - th[:, None]
    return x, _knee_f(x, hk[:, None], kind), _knee_fp(x, hk[:, None], kind)


def _knee_adjoint(base, y, x, f, fp, cf, hk, kind):
    """For ``base`` = (gain cotangent) x gain: the envelope cotangent
    ``g`` and the tile sums ``(dth, dcf, dhk)``."""
    cf = cf[:, None]
    g = base * cf * fp / (y + _EPS)
    return (
        g,
        _tile_sum(-base * cf * fp),
        _tile_sum(base * f),
        _tile_sum(base * cf * _knee_fhk(x, hk[:, None], kind)),
    )


def ballistics_plain(u, zi, at, rt):
    """Plain version of :func:`ballistics_core` (any device)."""
    return _walk(u, zi, at, rt)


def ballistics_fwd_plain(u, zi, at, rt):
    """Plain version of :func:`ballistics_fwd` (any device)."""
    y = _walk(u, zi, at, rt)
    return y, _residual(u, y, zi)


def ballistics_bwd_plain(d, g, at, rt):
    """Plain version of :func:`ballistics_bwd` (any device)."""
    du, dat, drt, dzi = _reverse_walk(g, d, at, rt)
    return du, dzi, dat, drt


def reverse_scan_plain(a, g):
    """Plain version of :func:`reverse_scan` (any device)."""
    gh = torch.empty_like(g)
    st = torch.zeros_like(g[:, 0])
    for n in range(g.shape[1] - 1, -1, -1):
        st = torch.addcmul(g[:, n], a[:, n], st)
        gh[:, n] = st
    return gh


def ballistics_gain_plain(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Plain version of :func:`ballistics_gain_core` (any device)."""
    return ballistics_gain_fwd_plain(u, zi, at, rt, th, cf, hk, kind)[0]


def ballistics_gain_fwd_plain(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Plain version of :func:`ballistics_gain_fwd` (any device)."""
    y = _walk(u, zi, at, rt)
    return _knee_gain(y, th, cf, hk, kind), _residual(u, y, zi), y[:, -1].clone()


def ballistics_gain_bwd_plain(u, d, y_last, gg, at, rt, th, cf, hk, kind="compressor"):
    """Plain version of :func:`ballistics_gain_bwd` (any device)."""
    y = _rebuild(u - d, y_last)
    x, f, fp = _knee_terms(y, th, hk, kind)
    base = gg * torch.exp(cf[:, None] * f)
    g, dth, dcf, dhk = _knee_adjoint(base, y, x, f, fp, cf, hk, kind)
    du, dat, drt, dzi = _reverse_walk(g, d, at, rt)
    return du, dzi, dat, drt, dth, dcf, dhk


def ballistics_gain_pair_plain(u, *consts, kinds=("noisegate", "compressor"), inits=(1.0, 1.0)):
    """Plain version of :func:`ballistics_gain_pair_core` (any device)."""
    return ballistics_gain_pair_fwd_plain(u, *consts, kinds=kinds, inits=inits)[0]


def ballistics_gain_pair_fwd_plain(
    u, at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"), inits=(1.0, 1.0),
):
    """Plain version of :func:`ballistics_gain_pair_fwd` (any device)."""
    init_a = torch.full_like(at_a, inits[0])
    init_b = torch.full_like(at_b, inits[1])
    v = _walk(u, init_a, at_a, rt_a)
    ga = _knee_gain(v, th_a, cf_a, hk_a, kinds[0])
    ec = ga * ga * u
    u2 = _walk(ec, init_b, at_b, rt_b)
    gb = _knee_gain(u2, th_b, cf_b, hk_b, kinds[1])
    return (
        ga * gb,
        _residual(u, v, init_a),
        _residual(ec, u2, init_b),
        v[:, -1].clone(),
        u2[:, -1].clone(),
    )


def ballistics_gain_pair_bwd_plain(
    u, d_a, d_b, v_last, u_last, gg,
    at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"),
):
    """Plain version of :func:`ballistics_gain_pair_bwd` (any device)."""
    v = _rebuild(u - d_a, v_last)
    xa, fa, fpa = _knee_terms(v, th_a, hk_a, kinds[0])
    ga = torch.exp(cf_a[:, None] * fa)
    ec = ga * ga * u
    u2 = _rebuild(ec - d_b, u_last)
    xb, fb, fpb = _knee_terms(u2, th_b, hk_b, kinds[1])
    gb = torch.exp(cf_b[:, None] * fb)
    # second member: base_b is its gain's cotangent times gb
    base_b = gg * ga * gb
    g2, dth_b, dcf_b, dhk_b = _knee_adjoint(base_b, u2, xb, fb, fpb, cf_b, hk_b, kinds[1])
    dec, dat_b, drt_b, _ = _reverse_walk(g2, d_b, at_b, rt_b)
    # first member: ga reaches the output directly and through ec = ga^2 u
    base_a = base_b + dec * 2.0 * ga * ga * u
    g1, dth_a, dcf_a, dhk_a = _knee_adjoint(base_a, v, xa, fa, fpa, cf_a, hk_a, kinds[0])
    du_walk, dat_a, drt_a, _ = _reverse_walk(g1, d_a, at_a, rt_a)
    return (
        du_walk + dec * ga * ga,
        dat_a, drt_a, dth_a, dcf_a, dhk_a,
        dat_b, drt_b, dth_b, dcf_b, dhk_b,
    )


# The dynamics chain: member i's rows of its (8 M, N) constants.
CHAIN_ROWS = ("at", "rt", "th", "cf", "hk", "at_g", "rt_g", "present")
_SMOOTHS = {None: 0, "linear": 1, "log": 2}


def chain_walks(spec):
    """The chain's recursions in walk order, ``[(member, is_gain_walk)]``:
    each member's energy walk, then its gain walk where it smooths its
    gain."""
    walks = []
    for i, (_, smooth) in enumerate(spec):
        walks.append((i, False))
        if smooth is not None:
            walks.append((i, True))
    return walks


def chain_code(spec):
    """The kernels' integer form of a chain ``spec``: bit 0 the members
    less one; member i's kind (0 compressor, 1 noise gate) at bit 1 + 3i
    and its gain smoothing (0 none, 1 linear, 2 log) at bits 2 + 3i."""
    if not 1 <= len(spec) <= 2:
        raise ValueError(f"a dynamics chain has one or two members, got {len(spec)}")
    code = len(spec) - 1
    for i, (kind, smooth) in enumerate(spec):
        code |= (_KINDS[kind] | _SMOOTHS[smooth] << 1) << (1 + 3 * i)
    return code


def chain_spec(code):
    """The ``spec`` of :func:`chain_code`'s ``code``."""
    kinds, smooths = {v: k for k, v in _KINDS.items()}, {v: k for k, v in _SMOOTHS.items()}
    return tuple(
        (kinds[(code >> (1 + 3 * i)) & 1], smooths[(code >> (2 + 3 * i)) & 3])
        for i in range((code & 1) + 1)
    )


def _chain_members(consts, spec):
    """Member i's eight ``(N,)`` constant rows (:data:`CHAIN_ROWS`)."""
    return consts.reshape(len(spec), len(CHAIN_ROWS), -1)


def ballistics_chain_plain(u, consts, zi, spec):
    """Plain version of :func:`ballistics_chain_core` (any device)."""
    gain, _, last = _chain_forward(u, consts, zi, spec)
    return gain, last


def ballistics_chain_fwd_plain(u, consts, zi, spec):
    """Plain version of :func:`ballistics_chain_fwd` (any device)."""
    return _chain_forward(u, consts, zi, spec)


def _chain_forward(u, consts, zi, spec):
    """The chain's gain, each walk's residual ``(R, N, L)`` and final
    state ``(R, N)``."""
    members = _chain_members(consts, spec)
    x, gain, d, last, r = u, None, [], [], 0

    def walk(v, at, rt):
        nonlocal r
        y = _walk(v, zi[r], at, rt)
        d.append(_residual(v, y, zi[r]))
        last.append(y[:, -1])
        r += 1
        return y

    for i, (kind, smooth) in enumerate(spec):
        at, rt, th, cf, hk, at_g, rt_g, present = members[i]
        e = walk(x, at, rt)
        lg = cf[:, None] * _knee_f(torch.log(e + _EPS) - th[:, None], hk[:, None], kind)
        if smooth is None:
            g = torch.exp(lg)
        else:
            s = walk(lg if smooth == "log" else torch.exp(lg), at_g, rt_g)
            g = torch.exp(s) if smooth == "log" else s
        g = torch.where(present[:, None] > 0.5, g, 1.0)
        gain = g if gain is None else gain * g
        if i + 1 < len(spec):
            x = gain * gain * u
    return gain, torch.stack(d), torch.stack(last)


def ballistics_chain_bwd_plain(u, d, last, gg, consts, spec):
    """Plain version of :func:`ballistics_chain_bwd` (any device)."""
    members = _chain_members(consts, spec)
    # the forward again, from the residuals: each walk's output is (x - d)[n+1]
    fwd, x, gain, r = [], u, None, 0
    for i, (kind, smooth) in enumerate(spec):
        at, rt, th, cf, hk, at_g, rt_g, present = members[i]
        e = _rebuild(x - d[r], last[r])
        xk, f, fp = _knee_terms(e, th, hk, kind)
        lg = cf[:, None] * f
        v = None
        if smooth is None:
            graw = torch.exp(lg)
        else:
            v = lg if smooth == "log" else torch.exp(lg)
            s = _rebuild(v - d[r + 1], last[r + 1])
            graw = torch.exp(s) if smooth == "log" else s
        g = torch.where(present[:, None] > 0.5, graw, 1.0)
        fwd.append(dict(x=x, e=e, xk=xk, f=f, fp=fp, v=v, g=g, r=r))
        r += 1 + (smooth is not None)
        gain = g if gain is None else gain * g
        if i + 1 < len(spec):
            x = gain * gain * u
    dconsts = torch.zeros_like(members)
    dzi = torch.zeros_like(last)
    du, dx = None, None
    for i in range(len(spec) - 1, -1, -1):
        kind, smooth = spec[i]
        at, rt, th, cf, hk, at_g, rt_g, present = members[i]
        m = fwd[i]
        # G: the cotangent of the member's gain g_i
        G = gg if len(spec) == 1 else gg * fwd[1 - i]["g"]
        if dx is not None:  # member 0's gain also reaches the output through x_1 = g_0^2 u
            G = G + dx * 2.0 * m["g"] * u
            du = dx * m["g"] * m["g"]
        G = torch.where(present[:, None] > 0.5, G, 0.0)
        r = m["r"]
        if smooth is None:
            dlg = G * m["g"]
        else:
            gs = G * m["g"] if smooth == "log" else G
            dv, dconsts[i, 5], dconsts[i, 6], dzi[r + 1] = _reverse_walk(gs, d[r + 1], at_g, rt_g)
            dlg = dv if smooth == "log" else dv * m["v"]
        de, dconsts[i, 2], dconsts[i, 3], dconsts[i, 4] = _knee_adjoint(
            dlg, m["e"], m["xk"], m["f"], m["fp"], cf, hk, kind
        )
        dx, dconsts[i, 0], dconsts[i, 1], dzi[r] = _reverse_walk(de, d[r], at, rt)
    du = dx if du is None else du + dx
    return du, dconsts.reshape(consts.shape), dzi


# The frame gain: a FactorizedCompressor's pool, frame walk, lerp and knee.


def frame_means(u, frame_len):
    """``(N, F)`` means of ``(N, L)`` rows over frames of ``frame_len``
    samples, the last one zero-padded and divided by ``frame_len`` all the
    same."""
    n, length = u.shape
    return F.pad(u, (0, -length % frame_len)).reshape(n, -1, frame_len).mean(-1)


def _frame_weights(frame_len, like):
    """``(first, frac)`` of each offset of a frame: whether it lies before
    the frame's centre, and the lerp's weight of its second operand."""
    w = (torch.arange(frame_len, dtype=like.dtype, device=like.device) + 0.5) / frame_len
    first = w < 0.5
    return first, torch.where(first, w + 0.5, w - 0.5)


def frame_lerp(s, frame_len, length):
    """``(N, F)`` frame values back to ``(N, length)`` samples: sample ``j``
    of a frame lies between two frame centres, so it is a lerp between the
    previous / current / next frame values with a fixed weight pattern per
    offset, flat at the edges, and no gather."""
    first, frac = _frame_weights(frame_len, s)
    s_prev = torch.cat([s[:, :1], s[:, :-1]], dim=1)
    s_next = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
    a = torch.where(first, s_prev[..., None], s[..., None])
    b = torch.where(first, s[..., None], s_next[..., None])
    up = a * (1.0 - frac) + b * frac  # (N, F, frame_len)
    return up.reshape(s.shape[0], -1)[:, :length]


def _frame_lerp_adjoint(g, frame_len, frames):
    """The cotangent ``(N, F)`` of :func:`frame_lerp`'s frame values from
    that of its ``(N, L)`` output: each frame's sums of what reaches the
    previous, its own and the next frame value, the clamped ends adding a
    frame's own."""
    n, length = g.shape
    first, frac = _frame_weights(frame_len, g)
    gp = F.pad(g, (0, frames * frame_len - length)).reshape(n, frames, frame_len)
    ga, gb = gp * (1.0 - frac), gp * frac  # the cotangents of a and b
    to_prev = torch.where(first, ga, 0.0).sum(-1)
    gs = torch.where(first, gb, ga).sum(-1)
    to_next = torch.where(first, 0.0, gb).sum(-1)
    gs[:, :-1] += to_prev[:, 1:]
    gs[:, 1:] += to_next[:, :-1]
    gs[:, 0] += to_prev[:, 0]
    gs[:, -1] += to_next[:, -1]
    return gs


def frame_gain_plain(u, at, rt, th, cf, hk, frame_len):
    """Plain version of :func:`frame_gain_core` (any device)."""
    return frame_gain_fwd_plain(u, at, rt, th, cf, hk, frame_len)[0]


def frame_gain_fwd_plain(u, at, rt, th, cf, hk, frame_len):
    """Plain version of :func:`frame_gain_fwd` (any device)."""
    frame_len = _frame_len(frame_len)
    m = frame_means(u, frame_len)
    zi = torch.ones_like(at)
    s = _walk(m, zi, at, rt)
    gain = _knee_gain(frame_lerp(s, frame_len, u.shape[1]), th, cf, hk, "compressor")
    return gain, s, _residual(m, s, zi)


def frame_gain_bwd_plain(s, d, gg, at, rt, th, cf, hk, frame_len):
    """Plain version of :func:`frame_gain_bwd` (any device)."""
    frame_len = _frame_len(frame_len)
    n, length = gg.shape
    v = frame_lerp(s, frame_len, length)
    x, f, fp = _knee_terms(v, th, hk, "compressor")
    base = gg * torch.exp(cf[:, None] * f)
    g, dth, dcf, dhk = _knee_adjoint(base, v, x, f, fp, cf, hk, "compressor")
    dm, dat, drt, _ = _reverse_walk(_frame_lerp_adjoint(g, frame_len, s.shape[1]), d, at, rt)
    de = (dm / frame_len)[..., None].expand(-1, -1, frame_len).reshape(n, -1)[:, :length]
    return de, dat, drt, dth, dcf, dhk


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _device(u, name):
    """``"cpu"`` or ``"cuda"``; anything else raises."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {u.device}")
    return u.device.type


def _operand(name, label, a, shape, device):
    """``a``, where it is a float32 ``shape`` tensor on ``device``; else
    raise."""
    if a.dtype != torch.float32 or tuple(a.shape) != tuple(shape) or a.device != device:
        raise ValueError(f"{name}: {label} must be a float32 {tuple(shape)} tensor on {device},"
                         f" got {a.dtype} {tuple(a.shape)} on {a.device}")
    return a


def _rows(name, *arrays):
    """Validate ``(N, L)`` float32 operands of one shape on one device;
    contiguous."""
    u = arrays[0]
    shape = tuple(u.shape) if u.dim() == 2 else ("N", "L")
    return [_operand(name, "every signal", a, shape, u.device).contiguous() for a in arrays]


def _consts(name, u, *consts):
    """Validate ``(N,)`` float32 constants; returns them stacked ``(k, N)``."""
    return torch.stack([_operand(name, "every constant", c, u.shape[:1], u.device)
                        for c in consts]).contiguous()


def _tiles(u):
    return -(-u.shape[1] // _TILE)


def _walk_chunk(u, chunk):
    """:func:`walk_chunk` for ``u``'s rows on ``u``'s device; a bad
    ``chunk`` raises on every device."""
    slots = walk_slots(u.device) if chunk is None and u.device.type == "cuda" else None
    return walk_chunk(u.shape[0], u.shape[-1], chunk, slots)


def _carry(u, chunk):
    """The reverse walk's ``(2, N, chunks)`` scratch for chunks of
    ``chunk`` samples of ``u``'s rows (``None`` for one chunk)."""
    n, length = u.shape
    chunks = -(-length // chunk)
    return u.new_empty(2, n, chunks) if chunks > 1 else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count_walks(u, walks):
    """Count, for ``walks`` forward walks over ``u``'s ``(N, L)`` rows, the
    samples walked in links and in single steps (the ragged tail): the
    tracer's ``ballistics.walk.linked`` and ``ballistics.walk.single``
    (:func:`grafx_tpu_torch.profiling.count`; report only)."""
    n, length = u.shape
    single = length % WALK_LINK
    profiling.count("ballistics.walk.linked", walks * n * (length - single))
    profiling.count("ballistics.walk.single", walks * n * single)


def _run(name, fn_name, u, *args):
    """Launch ``fn_name(*args, device, stream)``; raise on a CUDA error.
    The launch counts as wrapper ``name``'s (:func:`launch_counts`) and in
    the tracer's report as ``ballistics.<name>``
    (:func:`grafx_tpu_torch.profiling.count`)."""
    rc = getattr(_cuda.library(), fn_name)(
        *args, u.device.index, torch.cuda.current_stream(u.device).cuda_stream
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    profiling.count(f"ballistics.{name}")
    if name in _LAUNCHES:
        _LAUNCHES[name] += 1


def _kernel(chunked=False):
    """A kernel wrapper from its CUDA body, the decorated function: CUDA
    tensors run the body, CPU tensors its plain version (``<name>_plain``,
    looked up at the call) with the same arguments, and another device
    raises.  An adjoint (``chunked``) takes the CUDA reverse walk's
    ``chunk`` (:func:`walk_chunk`; None picks it from the shape and the
    card), resolved first, so that a bad one raises on every device."""

    def wrap(body):
        plain = f"{body.__name__}_plain"

        @functools.wraps(body)
        def wrapper(u, *args, **kwargs):
            if chunked:
                kwargs["chunk"] = _walk_chunk(u, kwargs.get("chunk"))
            if _device(u, body.__name__) == "cuda":
                return body(u, *args, **kwargs)
            kwargs.pop("chunk", None)
            return globals()[plain](u, *args, **kwargs)

        return wrapper

    return wrap


class _Family(NamedTuple):
    """What an op family's primal (``*_core``) differs in: its name, its
    custom op (:func:`_custom_op`) and the op's arguments from the
    primal's ``(tensors, static)``; its forward with residuals
    (``fwd(*tensors, *static)``), what of the tensors and the forward's
    outputs the adjoint reads (``keep``), and the adjoint
    (``adjoint(kept, cotangent, static)``: each tensor's gradient)."""

    name: str
    op: Callable
    op_args: Callable
    fwd: Callable
    keep: Callable
    adjoint: Callable
    states: bool = False  # the primal returns the walks' final states too


def _custom_op(name, schema, plain, cuda, fake=lambda u, *_: torch.empty_like(u)):
    """``torch.ops.grafx_tpu_torch.<name>``: ``plain`` (the plain version)
    on the CPU, ``cuda`` (the kernel's launch) on the card, and ``fake``,
    which gives the output's shapes."""
    op = torch.library.custom_op(f"grafx_tpu_torch::{name}", plain, mutates_args=(),
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _core(family, tensors, static):
    """A family's primal: with grad enabled and any tensor requiring grad
    its forward with residuals and its adjoint (:class:`_Adjoint`), else
    its custom op."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Adjoint.apply(family, static, *tensors)
    _device(tensors[0], family.name)
    return family.op(*family.op_args(tensors, static))


class _Adjoint(torch.autograd.Function):
    """A family's primal under gradient, the ``custom_vjp`` of its
    ``grafx_tpu`` counterpart: the forward runs the family's forward with
    residuals and saves what its adjoint reads, the backward is the
    adjoint; the static arguments get no gradient."""

    @staticmethod
    def forward(ctx, family, static, *tensors):
        out = family.fwd(*tensors, *static)
        ctx.save_for_backward(*family.keep(tensors, out))
        ctx.family, ctx.static = family, static
        if family.states:
            ctx.mark_non_differentiable(out[-1])
            return out[0], out[-1]
        return out[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, gg, *_):
        return None, None, *ctx.family.adjoint(ctx.saved_tensors, gg, ctx.static)


def _gain_fwd_cuda(name, u, consts, kind, res, samples=None):
    """#2 (``res`` False: the gain) or #5 (``(gain, d, y_last)``) on the
    card, the walk's stage of ``samples`` (:func:`walk_samples`)."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    n, length = u.shape
    samples = walk_samples(length, samples)
    gain = torch.empty_like(u)
    _count_walks(u, 1)
    if not res:
        _run(name, "grafx_gain_fwd", u, u.data_ptr(), gain.data_ptr(), c.data_ptr(), n, length,
             _KINDS[kind], samples)
        return gain
    d, y_last = torch.empty_like(u), u.new_empty(n)
    _run(name, "grafx_gain_fwd_res", u, u.data_ptr(), gain.data_ptr(), d.data_ptr(),
         y_last.data_ptr(), c.data_ptr(), n, length, _KINDS[kind], samples)
    return gain, d, y_last


def ballistics_gain_core(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Ballistics smoothing + quadratic-knee gain in one call.

    Differentiable in every tensor argument.  Without grad it launches the
    primal-only kernel (replaces ``_fwd_gain_only_kernel``); with grad it
    runs :func:`ballistics_gain_fwd` and, backward,
    :func:`ballistics_gain_bwd`.

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
    return _core(_GAIN, (u, zi, at, rt, th, cf, hk), (kind,))


@_kernel()
def ballistics_gain_fwd(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Gain plus the adjoint's residuals (replaces ``_fwd_gain_kernel``).

    Returns:
        ``(gain, d, y_last)``: ``(N, L)`` gains, ``d = u - y[n-1]`` and
        the ``(N,)`` final envelope state.
    """
    return _gain_fwd_cuda("ballistics_gain_fwd", u, (zi, at, rt, th, cf, hk), kind, res=True)


@_kernel(chunked=True)
def ballistics_gain_bwd(u, d, y_last, gg, at, rt, th, cf, hk, kind="compressor", chunk=None):
    """Adjoint of :func:`ballistics_gain_fwd` for the gain cotangent
    ``gg`` (replaces ``_bwd_gain_kernel``).  ``chunk``: the CUDA reverse
    walk's chunk length (:func:`walk_chunk`; None picks it from the
    shape and the card); the plain version walks whole rows.

    Returns:
        ``(du, dzi, dat, drt, dth, dcf, dhk)``: ``du`` ``(N, L)``, the
        rest ``(N,)``.
    """
    name = "ballistics_gain_bwd"
    u, d, gg = _rows(name, u, d, gg)
    consts = _consts(name, u, at, rt, th, cf, hk)
    y_last = _consts(name, u, y_last)
    n = u.shape[0]
    du = torch.empty_like(u)
    grads = u.new_empty(6, n)
    partials = u.new_empty(5, n, _tiles(u))
    carry = _carry(u, chunk)
    _run(name, "grafx_gain_bwd", u, u.data_ptr(), d.data_ptr(), y_last.data_ptr(),
         gg.data_ptr(), consts.data_ptr(), du.data_ptr(), grads.data_ptr(),
         partials.data_ptr(), _ptr(carry), n, u.shape[1], chunk, _KINDS[kind])
    return (du, *grads.unbind(0))


def _pair_fwd_cuda(name, u, consts, kinds, inits, res, samples=None):
    """#1 (``res`` False: the gain) or #3 (``(gain, d_a, d_b, v_last,
    u_last)``) on the card, the walks' stage of ``samples``
    (:func:`walk_samples`)."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    n, length = u.shape
    tail = (n, length, _KINDS[kinds[0]], _KINDS[kinds[1]], float(inits[0]), float(inits[1]),
            walk_samples(length, samples))
    gain = torch.empty_like(u)
    _count_walks(u, 2)
    if not res:
        _run(name, "grafx_gain_pair_fwd", u, u.data_ptr(), gain.data_ptr(), c.data_ptr(), *tail)
        return gain
    d_a, d_b = torch.empty_like(u), torch.empty_like(u)
    lasts = u.new_empty(2, n)
    _run(name, "grafx_gain_pair_fwd_res", u, u.data_ptr(), gain.data_ptr(), d_a.data_ptr(),
         d_b.data_ptr(), lasts[0].data_ptr(), lasts[1].data_ptr(), c.data_ptr(), *tail)
    return gain, d_a, d_b, lasts[0], lasts[1]


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

    Differentiable in ``u`` and the ten constants (``inits`` are static).
    Without grad it launches the primal-only kernel (replaces
    ``_fwd_gain_pair_only_kernel``); with grad it runs
    :func:`ballistics_gain_pair_fwd` and, backward,
    :func:`ballistics_gain_pair_bwd`.

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
    return _core(_PAIR, (u, *consts), (tuple(kinds), tuple(inits)))


@_kernel()
def ballistics_gain_pair_fwd(
    u, at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"), inits=(1.0, 1.0),
):
    """Pair gain plus the adjoint's residuals (replaces
    ``_fwd_gain_pair_kernel``).

    Returns:
        ``(gain, d_a, d_b, v_last, u_last)``: ``d_a = u - v[n-1]`` and
        ``d_b = ec - u2[n-1]`` for the members' envelopes ``v``, ``u2``
        and the gated energy ``ec = g_a^2 u``, and their final states.
    """
    consts = (at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b)
    return _pair_fwd_cuda("ballistics_gain_pair_fwd", u, consts, kinds, inits, res=True)


@_kernel(chunked=True)
def ballistics_gain_pair_bwd(
    u, d_a, d_b, v_last, u_last, gg,
    at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b,
    kinds=("noisegate", "compressor"), chunk=None,
):
    """Adjoint of :func:`ballistics_gain_pair_fwd` for the gain cotangent
    ``gg`` (replaces ``_bwd_gain_pair_kernel``).  ``chunk`` as for
    :func:`ballistics_gain_bwd`, for both members' walks.

    Returns:
        ``(du, dat_a, drt_a, dth_a, dcf_a, dhk_a, dat_b, drt_b, dth_b,
        dcf_b, dhk_b)``: ``du`` ``(N, L)``, the rest ``(N,)``.
    """
    name = "ballistics_gain_pair_bwd"
    u, d_a, d_b, gg = _rows(name, u, d_a, d_b, gg)
    c = _consts(name, u, at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b)
    lasts = _consts(name, u, v_last, u_last)
    n = u.shape[0]
    du = torch.empty_like(u)
    scratch = u.new_empty(2, *u.shape)
    grads = u.new_empty(10, n)
    partials = u.new_empty(10, n, _tiles(u))
    carry = _carry(u, chunk)
    _run(name, "grafx_gain_pair_bwd", u, u.data_ptr(), d_a.data_ptr(), d_b.data_ptr(),
         lasts.data_ptr(), gg.data_ptr(), c.data_ptr(), du.data_ptr(), scratch.data_ptr(),
         grads.data_ptr(), partials.data_ptr(), _ptr(carry), n, u.shape[1], chunk,
         _KINDS[kinds[0]], _KINDS[kinds[1]])
    return (du, *grads.unbind(0))


def _walk_fwd_cuda(name, u, consts, res, samples=None):
    """#7 (``res`` False: ``y``) or #8 (``(y, d)``) on the card, the
    walk's stage of ``samples`` (:func:`walk_samples`)."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    y = torch.empty_like(u)
    d = torch.empty_like(u) if res else None
    _count_walks(u, 1)
    _run(name, "grafx_ballistics_fwd", u, u.data_ptr(), y.data_ptr(), _ptr(d), c.data_ptr(),
         u.shape[0], u.shape[1], walk_samples(u.shape[1], samples))
    return (y, d) if res else y


def ballistics_core(u, zi, at, rt):
    """The attack/release smoother alone, from per-row initial states.
    A stream carries its state with :func:`ballistics_stream`.

    Differentiable in every argument.  Without grad it launches the
    primal walk (replaces ``_kernel``); with grad it runs
    :func:`ballistics_fwd` and, backward, :func:`ballistics_bwd`, which
    save only ``d`` (with ``at`` and ``rt``), neither ``u`` nor ``y``.

    Args:
        u: ``(N, L)`` input envelopes.
        zi, at, rt: ``(N,)`` initial states and attack / release factors.

    Returns:
        ``(N, L)`` smoothed envelopes.
    """
    return _core(_WALK, (u, zi, at, rt), ())


@_kernel()
def ballistics_fwd(u, zi, at, rt):
    """The walk plus the adjoint's residual (replaces ``_fwd_d_kernel``).

    Returns:
        ``(y, d)``: ``(N, L)`` smoothed envelopes and ``d = u - y[n-1]``
        (``y[-1] = zi``), which holds the attack/release decisions
        (``d > 0``) and the factor of the coefficients' gradients.
    """
    return _walk_fwd_cuda("ballistics_fwd", u, (zi, at, rt), res=True)


@_kernel(chunked=True)
def ballistics_bwd(d, g, at, rt, chunk=None):
    """Adjoint of :func:`ballistics_fwd` for the output cotangent ``g``
    (replaces ``_bwd_fused_kernel``): with ``c = at`` where ``d > 0``
    else ``rt`` and ``gh[n] = g[n] + (1 - c[n+1]) gh[n+1]``,
    ``du = c gh``, ``dat`` / ``drt`` the sums of ``d gh`` over attack /
    release samples and ``dzi = (1 - c[0]) gh[0]``.  ``chunk`` as for
    :func:`ballistics_gain_bwd`.

    Returns:
        ``(du, dzi, dat, drt)``: ``du`` ``(N, L)``, the rest ``(N,)``.
    """
    name = "ballistics_bwd"
    d, g = _rows(name, d, g)
    consts = _consts(name, d, at, rt)
    n = d.shape[0]
    du = torch.empty_like(d)
    grads = d.new_empty(3, n)
    partials = d.new_empty(2, n, _tiles(d))
    carry = _carry(d, chunk)
    _run(name, "grafx_ballistics_bwd", d, d.data_ptr(), g.data_ptr(), consts.data_ptr(),
         du.data_ptr(), grads.data_ptr(), partials.data_ptr(), _ptr(carry), n, d.shape[1],
         chunk)
    return (du, *grads.unbind(0))


@_kernel(chunked=True)
def reverse_scan(a, g, chunk=None):
    """The first-order reverse recurrence ``gh[n] = g[n] + a[n] gh[n+1]``
    with ``gh[L] = 0`` over ``(N, L)`` rows (replaces ``_bwd_kernel``, the
    kernel of ``grafx_tpu.ops.ballistics_tpu.reverse_scan_pallas``).  On
    the card it is the adjoints' chunked reverse walk with the coefficient
    read (:func:`_reverse_scan_chunked` mirrors it); ``chunk`` as for
    :func:`ballistics_gain_bwd`.

    Returns:
        ``(N, L)`` ``gh``.
    """
    name = "reverse_scan"
    a, g = _rows(name, a, g)
    gh = torch.empty_like(g)
    carry = _carry(a, chunk)
    _run(name, "grafx_reverse_scan", a, a.data_ptr(), g.data_ptr(), gh.data_ptr(),
         _ptr(carry), a.shape[0], a.shape[1], chunk)
    return gh



def walk_state(zi):
    """A stream's initial state of linked walks from their ``(..., N)``
    initial states ``zi``: ``(zi, tail)`` with the empty ``(N, 0)`` tail
    of a stream that has begun no link (:func:`ballistics_stream`)."""
    return zi, zi.new_empty(zi.shape[-1], 0)


def _resume(u, state):
    """``(x, last, p)``: a block's input ``u`` behind the ``(N, p)`` samples
    of the link the last block ended in, and the walks' states entering
    that link, from a stream state ``(last, tail)``."""
    last, tail = state
    p = tail.shape[-1]
    return (torch.cat([tail, u], dim=-1) if p else u), last, p


def _links_of(x):
    """The samples of ``x``'s rows that whole links cover."""
    return x.shape[-1] // WALK_LINK * WALK_LINK


def ballistics_stream(u, state, at, rt):
    """One block of a streamed :func:`ballistics_core`: ``(y, new_state)``.

    A walk's links of :data:`WALK_LINK` samples start at its call's first
    sample, so one float carried between calls would start the next
    block's links where the last block ended, and a block that ends inside
    a link would round the walk otherwise than one call.  The state
    ``(last, tail)`` (:func:`walk_state`) is instead the state entering
    the link the last block ended in and that link's ``(N, p)`` samples so
    far; the block walks them again from ``last`` (their outputs are
    dropped: the last block's ragged tail gave them, by the same single
    steps).  Blocks of any length so equal one call over the stream bit
    for bit; with blocks of whole links the tail stays empty and a block
    is one :func:`ballistics_core` call on its own samples.
    """
    x, last, p = _resume(u, state)
    y = ballistics_core(x, last, at, rt)
    whole = _links_of(x)
    boundary = y[:, whole - 1] if whole else last  # a walk's output is its state
    return (y[:, p:] if p else y), (boundary, x[:, whole:])


def ballistics_chain_stream(u, consts, state, spec):
    """One block of a streamed :func:`ballistics_chain_core`: ``(gain,
    new_state)``, with the state ``(last, tail)`` of
    :func:`ballistics_stream` (``last`` the ``(R, N)`` states of the
    chain's walks, which walk the same links).  A block that ends inside a
    link runs the chain twice, on its whole links and on the rest, for the
    walks' states at the last link's end."""
    x, last, p = _resume(u, state)
    whole = _links_of(x)
    if whole == x.shape[-1]:
        gain, last = ballistics_chain_core(x, consts, last, spec)
    else:
        parts = []
        if whole:
            head, last = ballistics_chain_core(x[:, :whole].contiguous(), consts, last, spec)
            parts.append(head)
        parts.append(ballistics_chain_core(x[:, whole:].contiguous(), consts, last, spec)[0])
        gain = torch.cat(parts, dim=-1)
    return (gain[:, p:] if p else gain), (last, x[:, whole:])


def ballistics_chain_core(u, consts, zi, spec):
    """A gain-smoothed dynamics run, one or two members (a gate then a
    compressor, or either alone), in one call: the port's own kernel, for
    the composed path of ``grafx_tpu`` (each member's ``gain_from_energy``
    threaded by ``FusedDynamicsChain``), which runs each smoother as its
    own walk.

    Member i smooths its energy ``e_i = (g_0 ... g_(i-1))^2 u`` by the
    ballistics walk (an exact one-pole: ``at == rt == 1 - alpha`` from
    state 0), applies the quadratic knee, ``lg = cf f(log(e + 1e-5) -
    th)``, and where it smooths its gain walks ``lg`` (``"log"``, then
    ``exp``) or ``exp(lg)`` (``"linear"``) with its gain's ``at_g``,
    ``rt_g``; else its gain is ``exp(lg)``.  An absent member
    (``present`` <= 0.5) has gain exactly 1.  Out: the product of the
    gains, and each walk's final state.

    Differentiable in ``u``, ``consts`` and ``zi``.  Without grad it
    launches the primal kernel; with grad it runs
    :func:`ballistics_chain_fwd` and, backward, :func:`ballistics_chain_bwd`.
    The final states are no differentiable output.

    Args:
        u: ``(N, L)`` energy envelopes.
        consts: ``(8 M, N)``: member i's rows :data:`CHAIN_ROWS` at 8 i.
        zi: ``(R, N)`` initial state of each walk, in the order of
            :func:`chain_walks` (1.0 for ballistics and a gain, 0.0 for
            the one-pole; a stream carries its state with
            :func:`ballistics_chain_stream`).
        spec: per member ``(kind, smooth)``: ``"compressor"`` or
            ``"noisegate"``, and ``None``, ``"linear"`` or ``"log"``.

    Returns:
        ``(gain, last)``: ``(N, L)`` gains and ``(R, N)`` final states.
    """
    return _core(_CHAIN, (u, consts, zi), (tuple((kind, smooth) for kind, smooth in spec),))


def _chain_args(name, u, consts, zi, spec):
    """Validate the chain's operands for the card; returns them
    contiguous with the spec's code."""
    (u,) = _rows(name, u)
    n, rows = u.shape[0], len(CHAIN_ROWS) * len(spec)
    consts = _operand(name, "consts", consts, (rows, n), u.device)
    zi = _operand(name, "zi", zi, (len(chain_walks(spec)), n), u.device)
    return u, consts.contiguous(), zi.contiguous(), chain_code(spec)


def _chain_fwd_cuda(name, u, consts, zi, spec, res, samples=None):
    """The chain's primal (``res`` False: ``(gain, last)``) or its forward
    with residuals (``(gain, d, last)``) on the card, the walks' stage of
    ``samples`` (:func:`walk_samples`)."""
    u, c, zi, code = _chain_args(name, u, consts, zi, spec)
    n, length = u.shape
    gain, last = torch.empty_like(u), u.new_empty(zi.shape)
    d = u.new_empty(zi.shape[0], n, length) if res else None
    _count_walks(u, zi.shape[0])
    _run(name, "grafx_chain_fwd", u, u.data_ptr(), gain.data_ptr(), _ptr(d), last.data_ptr(),
         c.data_ptr(), zi.data_ptr(), n, length, code, walk_samples(length, samples))
    return (gain, d, last) if res else (gain, last)


@_kernel()
def ballistics_chain_fwd(u, consts, zi, spec):
    """The chain plus the adjoint's residuals.

    Returns:
        ``(gain, d, last)``: ``(N, L)`` gains, ``(R, N, L)`` residuals
        ``d = x - y[n-1]`` of each walk (input ``x``, output ``y``) and
        the ``(R, N)`` final states.
    """
    return _chain_fwd_cuda("ballistics_chain_fwd", u, consts, zi, spec, res=True)


@_kernel(chunked=True)
def ballistics_chain_bwd(u, d, last, gg, consts, spec, chunk=None):
    """Adjoint of :func:`ballistics_chain_fwd` for the gain cotangent
    ``gg``: the members' reverse walks (decisions held, each linear and
    walked in time chunks, ``chunk`` as for :func:`ballistics_gain_bwd`)
    with the knee adjoints between them.

    Returns:
        ``(du, dconsts, dzi)``: ``(N, L)``, ``(8 M, N)`` (each walk's
        ``at``/``rt`` and each member's ``th``, ``cf``, ``hk`` per-row
        sums; 0 for ``present`` and an unsmoothed gain's rows) and ``(R,
        N)``.
    """
    name = "ballistics_chain_bwd"
    u, gg = _rows(name, u, gg)
    u, c, last, code = _chain_args(name, u, consts, last, spec)
    d = _operand(name, "d", d, (last.shape[0], *u.shape), u.device).contiguous()
    n, length = u.shape
    du = torch.empty_like(u)
    grads = u.new_empty(c.shape[0] + last.shape[0], n)
    scratch = u.new_empty(2 * len(spec), n, length)
    partials = u.new_empty(c.shape[0], n, _tiles(u))
    carry = _carry(u, chunk)
    _run(name, "grafx_chain_bwd", u, u.data_ptr(), d.data_ptr(), last.data_ptr(), gg.data_ptr(),
         c.data_ptr(), du.data_ptr(), grads.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
         _ptr(carry), n, length, chunk, code)
    return du, grads[: c.shape[0]], grads[c.shape[0]:]


def frame_gain_core(u, at, rt, th, cf, hk, frame_len):
    """A ``FactorizedCompressor``'s gain from its energy in one op: the
    port's own kernels, for ``grafx_tpu``'s ``_FrameSmoother`` and knee
    (pool, frame walk, lerp and knee, each its own pass there).

    ``u`` is mean-pooled into frames of ``frame_len`` samples (the last
    zero-padded and divided by ``frame_len`` all the same), the frame means
    walked by the ballistics recursion from 1, the walk lerped back to the
    sample rate between frame centres (flat at the edges), and the gain is
    the compressor's quadratic knee on it, ``exp(cf f(log(v + 1e-5) -
    th))``.

    Differentiable in every tensor argument.  Without grad it launches the
    primal; with grad it runs :func:`frame_gain_fwd` and, backward,
    :func:`frame_gain_bwd`, which save only the frame walk's ``(N, F)``
    residuals.

    Args:
        u: ``(N, L)`` energy envelopes.
        at, rt: ``(N,)`` attack and release factors.
        th, cf, hk: ``(N,)`` knee constants as for
            :func:`ballistics_gain_core`.
        frame_len: samples a frame, a positive int.

    Returns:
        ``(N, L)`` gains.
    """
    return _core(_FRAME, (u, at, rt, th, cf, hk), (_frame_len(frame_len),))


def _frame_len(frame_len):
    if isinstance(frame_len, bool) or not isinstance(frame_len, int) or frame_len <= 0:
        raise ValueError(f"frame_len must be a positive int, got {frame_len!r}")
    return frame_len


def _frame_fwd_cuda(name, u, consts, frame_len, res):
    """The frame gain's primal (``res`` False: the gain) or its forward with
    the residuals (``(gain, s, d)``) on the card."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    n, length = u.shape
    frames = -(-length // _frame_len(frame_len))
    gain = torch.empty_like(u)
    m, s = u.new_empty(2, n, frames).unbind(0)
    d = u.new_empty(n, frames) if res else None
    _count_walks(s, 1)
    _run(name, "grafx_frame_gain_fwd", u, u.data_ptr(), gain.data_ptr(), m.data_ptr(),
         s.data_ptr(), _ptr(d), c.data_ptr(), n, length, frame_len)
    return (gain, s, d) if res else gain


@_kernel()
def frame_gain_fwd(u, at, rt, th, cf, hk, frame_len):
    """The frame gain plus the adjoint's residuals.

    Returns:
        ``(gain, s, d)``: ``(N, L)`` gains, the ``(N, F)`` walked frame
        envelope ``s`` and ``d = m - s[i-1]`` (``m`` the frame means,
        ``s[-1] = 1``), which holds the attack/release decisions.
    """
    return _frame_fwd_cuda("frame_gain_fwd", u, (at, rt, th, cf, hk), frame_len, res=True)


@_kernel()
def frame_gain_bwd(s, d, gg, at, rt, th, cf, hk, frame_len):
    """Adjoint of :func:`frame_gain_fwd` for the gain cotangent ``gg``:
    the knee's adjoint, the lerp's reduced into frame cotangents, the frame
    walk's reverse walk (the decisions held) and the pool's, broadcast back
    to the samples.

    Returns:
        ``(du, dat, drt, dth, dcf, dhk)``: ``du`` ``(N, L)``, the rest
        ``(N,)``.
    """
    name = "frame_gain_bwd"
    frame_len = _frame_len(frame_len)
    (gg,) = _rows(name, gg)
    n, length = gg.shape
    frames = -(-length // frame_len)
    s, d = _rows(name, _operand(name, "s", s, (n, frames), gg.device), d)
    consts = _consts(name, gg, at, rt, th, cf, hk)
    du = torch.empty_like(gg)
    part = gg.new_empty(6, n, frames)
    dm = gg.new_empty(n, frames)
    grads = gg.new_empty(5, n)
    _run(name, "grafx_frame_gain_bwd", gg, s.data_ptr(), d.data_ptr(), gg.data_ptr(),
         consts.data_ptr(), du.data_ptr(), part.data_ptr(), dm.data_ptr(), grads.data_ptr(), n,
         length, frame_len)
    return (du, *grads.unbind(0))


KERNEL_WRAPPERS = (
    ballistics_gain_pair_core,
    ballistics_gain_core,
    ballistics_gain_pair_fwd,
    ballistics_gain_pair_bwd,
    ballistics_gain_fwd,
    ballistics_gain_bwd,
    ballistics_core,
    ballistics_fwd,
    ballistics_bwd,
    reverse_scan,
    ballistics_chain_core,
    ballistics_chain_fwd,
    ballistics_chain_bwd,
    frame_gain_core,
    frame_gain_fwd,
    frame_gain_bwd,
)
# each wrapper's kernel launches, counted by _run
_LAUNCHES = dict.fromkeys((w.__name__ for w in KERNEL_WRAPPERS), 0)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts():
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return dict(_LAUNCHES)


# The op families' primals (#2 / #5 / #6, #1 / #3 / #4, #7 / #8 / #9, the
# chain's and the frame gain's): their custom ops, and under gradient.

_GAIN = _Family(
    name="ballistics_gain_core",
    op=_custom_op("ballistics_gain", "(Tensor u, Tensor[] consts, str kind) -> Tensor",
                  lambda u, consts, kind: ballistics_gain_plain(u, *consts, kind),
                  lambda u, consts, kind: _gain_fwd_cuda(
                      "ballistics_gain_core", u, consts, kind, False)),
    op_args=lambda t, static: (t[0], t[1:], *static),
    fwd=ballistics_gain_fwd,
    keep=lambda t, out: (t[0], *out[1:], *t[2:]),
    adjoint=lambda kept, gg, static: ballistics_gain_bwd(*kept[:3], gg, *kept[3:], *static),
)
_PAIR = _Family(
    name="ballistics_gain_pair_core",
    op=_custom_op("ballistics_gain_pair", "(Tensor u, Tensor[] consts, str kind_a, str kind_b,"
                  " float init_a, float init_b) -> Tensor",
                  lambda u, consts, ka, kb, ia, ib: ballistics_gain_pair_plain(
                      u, *consts, kinds=(ka, kb), inits=(ia, ib)),
                  lambda u, consts, ka, kb, ia, ib: _pair_fwd_cuda(
                      "ballistics_gain_pair_core", u, consts, (ka, kb), (ia, ib), False)),
    op_args=lambda t, static: (t[0], t[1:], *static[0], *map(float, static[1])),
    fwd=ballistics_gain_pair_fwd,
    keep=lambda t, out: (t[0], *out[1:], *t[1:]),
    adjoint=lambda kept, gg, static: ballistics_gain_pair_bwd(*kept[:5], gg, *kept[5:], static[0]),
)
_WALK = _Family(
    name="ballistics_core",
    op=_custom_op("ballistics", "(Tensor u, Tensor[] consts) -> Tensor",
                  lambda u, consts: ballistics_plain(u, *consts),
                  lambda u, consts: _walk_fwd_cuda("ballistics_core", u, consts, False)),
    op_args=lambda t, static: (t[0], t[1:]),
    fwd=ballistics_fwd,
    keep=lambda t, out: (out[1], *t[2:]),  # d, at, rt: neither u nor y
    adjoint=lambda kept, gg, static: ballistics_bwd(kept[0], gg, *kept[1:]),
)
_CHAIN = _Family(
    name="ballistics_chain_core",
    op=_custom_op("ballistics_chain",
                  "(Tensor u, Tensor consts, Tensor zi, SymInt code) -> (Tensor, Tensor)",
                  lambda u, consts, zi, code: ballistics_chain_plain(u, consts, zi, chain_spec(code)),
                  lambda u, consts, zi, code: _chain_fwd_cuda(
                      "ballistics_chain_core", u, consts, zi, chain_spec(code), False),
                  lambda u, consts, zi, code: (torch.empty_like(u), torch.empty_like(zi))),
    op_args=lambda t, static: (*t, chain_code(*static)),
    fwd=ballistics_chain_fwd,
    keep=lambda t, out: (t[0], *out[1:], t[1]),
    adjoint=lambda kept, gg, static: ballistics_chain_bwd(*kept[:3], gg, kept[3], *static),
    states=True,
)
_FRAME = _Family(
    name="frame_gain_core",
    op=_custom_op("frame_gain", "(Tensor u, Tensor[] consts, SymInt frame_len) -> Tensor",
                  lambda u, consts, frame_len: frame_gain_plain(u, *consts, frame_len),
                  lambda u, consts, frame_len: _frame_fwd_cuda(
                      "frame_gain_core", u, consts, frame_len, False)),
    op_args=lambda t, static: (t[0], t[1:], *static),
    fwd=frame_gain_fwd,
    keep=lambda t, out: (*out[1:], *t[1:]),  # s, d and the constants: nothing (N, L)
    adjoint=lambda kept, gg, static: frame_gain_bwd(*kept[:2], gg, *kept[2:], *static),
)
