"""Ballistics smoothing, alone and fused with a quadratic-knee gain.

The port of :func:`grafx_tpu.ops.ballistics.ballistics_core`,
:func:`~grafx_tpu.ops.ballistics.ballistics_gain_core` and
:func:`~grafx_tpu.ops.ballistics.ballistics_gain_pair_core` with their
``custom_vjp``s, and of the reverse scan ``reverse_scan_pallas``: ten
kernels; and the dynamics chain, the port's own kernel for a
gain-smoothed dynamics run (below).  Each has two implementations of one
contract:

* a plain PyTorch version (``*_plain``): loops over time, vectorized
  over rows.  The wrapper uses it for CPU tensors; it is also the
  reference the CUDA kernel is held against on the card;
* a CUDA kernel written for Hopper (``csrc/ballistics_gain.cu`` for the
  forwards, ``csrc/ballistics_grad.cu`` for the adjoints), which the
  wrapper launches for CUDA tensors.  There is no fallback: a CUDA
  tensor reaches the kernel or the wrapper raises.

Each wrapper counts its kernel launches in its ``launches`` attribute.

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
first sample to its last.  On the card a block walks one row, staged
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

The primal kernels #1, #2 and #7 and the chain's, which a served render
and a stream block launch, are ``torch.library`` custom ops
(``torch.ops.grafx_tpu_torch.ballistics_gain_pair``, ``.ballistics_gain``,
``.ballistics`` and ``.ballistics_chain``): the CPU implementation is the
plain version, the CUDA one the kernel's launch, and a fake
implementation gives the output's shape.  ``torch.export`` so records one op where it would
otherwise unroll the plain version's loop over time, and could not see a
ctypes call.
"""

import ctypes
import functools
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from grafx_tpu_torch.ops import _cuda

_EPS = 1e-5
_TILE = 32
_KINDS = {"compressor": 0, "noisegate": 1}
_MIN_CHUNK = 64
_STAGE = 1024  # the most samples a stage of the forward walks holds


def fused_gain_available():
    """The fused gain path runs on every device: a kernel on CUDA, the
    plain version on the CPU."""
    return True


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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _device(u, name):
    """``"cpu"`` or ``"cuda"``; anything else raises."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {u.device}")
    return u.device.type


def _rows(name, *arrays):
    """Validate ``(N, L)`` float32 operands on one device; contiguous."""
    shape, device = arrays[0].shape, arrays[0].device
    for a in arrays:
        if a.dtype != torch.float32 or a.dim() != 2 or a.shape != shape or a.device != device:
            raise ValueError(
                f"{name}: every signal must be a float32 {tuple(shape)} tensor on"
                f" {device}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    return [a.contiguous() for a in arrays]


def _consts(name, u, *consts):
    """Validate ``(N,)`` float32 constants; returns them stacked ``(k, N)``."""
    n = u.shape[0]
    for c in consts:
        if c.shape != (n,) or c.device != u.device or c.dtype != torch.float32:
            raise ValueError(f"{name}: every constant must be a float32 ({n},) tensor on {u.device}")
    return torch.stack(consts).contiguous()


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


def _run(name, fn_name, u, *args):
    """Launch ``fn_name(*args, device, stream)``; raise on a CUDA error."""
    rc = getattr(_cuda.library(), fn_name)(
        *args, u.device.index, torch.cuda.current_stream(u.device).cuda_stream
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


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
    args = (u, zi, at, rt, th, cf, hk)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _Gain.apply(*args, kind)
    _device(u, "ballistics_gain_core")
    return torch.ops.grafx_tpu_torch.ballistics_gain(u, args[1:], kind)


@torch.library.custom_op("grafx_tpu_torch::ballistics_gain", mutates_args=())
def _gain_op(u: torch.Tensor, consts: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    """#2 as a custom op; ``consts`` = (zi, at, rt, th, cf, hk)."""
    return ballistics_gain_plain(u, *consts, kind)


@_gain_op.register_kernel("cuda")
def _gain_op_cuda(u, consts, kind):
    gain = _gain_fwd_cuda("ballistics_gain_core", u, consts, kind, res=False)
    ballistics_gain_core.launches += 1
    return gain


@_gain_op.register_fake
def _gain_op_fake(u, consts, kind):
    return torch.empty_like(u)


def _gain_fwd_cuda(name, u, consts, kind, res, samples=None):
    """#2 (``res`` False: the gain) or #5 (``(gain, d, y_last)``) on the
    card, the walk's stage of ``samples`` (:func:`walk_samples`)."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    n, length = u.shape
    samples = walk_samples(length, samples)
    gain = torch.empty_like(u)
    if not res:
        _run(name, "grafx_gain_fwd", u, u.data_ptr(), gain.data_ptr(), c.data_ptr(), n, length,
             _KINDS[kind], samples)
        return gain
    d, y_last = torch.empty_like(u), u.new_empty(n)
    _run(name, "grafx_gain_fwd_res", u, u.data_ptr(), gain.data_ptr(), d.data_ptr(),
         y_last.data_ptr(), c.data_ptr(), n, length, _KINDS[kind], samples)
    return gain, d, y_last


def ballistics_gain_fwd(u, zi, at, rt, th, cf, hk, kind="compressor"):
    """Gain plus the adjoint's residuals (replaces ``_fwd_gain_kernel``).

    Returns:
        ``(gain, d, y_last)``: ``(N, L)`` gains, ``d = u - y[n-1]`` and
        the ``(N,)`` final envelope state.
    """
    name = "ballistics_gain_fwd"
    if _device(u, name) == "cpu":
        return ballistics_gain_fwd_plain(u, zi, at, rt, th, cf, hk, kind)
    out = _gain_fwd_cuda(name, u, (zi, at, rt, th, cf, hk), kind, res=True)
    ballistics_gain_fwd.launches += 1
    return out


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
    chunk = _walk_chunk(u, chunk)
    if _device(u, name) == "cpu":
        return ballistics_gain_bwd_plain(u, d, y_last, gg, at, rt, th, cf, hk, kind)
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
    ballistics_gain_bwd.launches += 1
    return (du, *grads.unbind(0))


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
    if torch.is_grad_enabled() and any(a.requires_grad for a in (u, *consts)):
        return _GainPair.apply(u, *consts, tuple(kinds), tuple(inits))
    _device(u, "ballistics_gain_pair_core")
    return torch.ops.grafx_tpu_torch.ballistics_gain_pair(
        u, consts, kinds[0], kinds[1], float(inits[0]), float(inits[1])
    )


@torch.library.custom_op("grafx_tpu_torch::ballistics_gain_pair", mutates_args=())
def _pair_op(
    u: torch.Tensor, consts: Sequence[torch.Tensor], kind_a: str, kind_b: str,
    init_a: float, init_b: float,
) -> torch.Tensor:
    """#1 as a custom op; ``consts`` = the ten member constants."""
    return ballistics_gain_pair_plain(u, *consts, kinds=(kind_a, kind_b), inits=(init_a, init_b))


@_pair_op.register_kernel("cuda")
def _pair_op_cuda(u, consts, kind_a, kind_b, init_a, init_b):
    gain = _pair_fwd_cuda("ballistics_gain_pair_core", u, consts, (kind_a, kind_b),
                          (init_a, init_b), res=False)
    ballistics_gain_pair_core.launches += 1
    return gain


@_pair_op.register_fake
def _pair_op_fake(u, consts, kind_a, kind_b, init_a, init_b):
    return torch.empty_like(u)


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
    if not res:
        _run(name, "grafx_gain_pair_fwd", u, u.data_ptr(), gain.data_ptr(), c.data_ptr(), *tail)
        return gain
    d_a, d_b = torch.empty_like(u), torch.empty_like(u)
    lasts = u.new_empty(2, n)
    _run(name, "grafx_gain_pair_fwd_res", u, u.data_ptr(), gain.data_ptr(), d_a.data_ptr(),
         d_b.data_ptr(), lasts[0].data_ptr(), lasts[1].data_ptr(), c.data_ptr(), *tail)
    return gain, d_a, d_b, lasts[0], lasts[1]


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
    name = "ballistics_gain_pair_fwd"
    consts = (at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b)
    if _device(u, name) == "cpu":
        return ballistics_gain_pair_fwd_plain(u, *consts, kinds=kinds, inits=inits)
    out = _pair_fwd_cuda(name, u, consts, kinds, inits, res=True)
    ballistics_gain_pair_fwd.launches += 1
    return out


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
    consts = (at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b, cf_b, hk_b)
    chunk = _walk_chunk(u, chunk)
    if _device(u, name) == "cpu":
        return ballistics_gain_pair_bwd_plain(
            u, d_a, d_b, v_last, u_last, gg, *consts, kinds=kinds
        )
    u, d_a, d_b, gg = _rows(name, u, d_a, d_b, gg)
    c = _consts(name, u, *consts)
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
    ballistics_gain_pair_bwd.launches += 1
    return (du, *grads.unbind(0))


def ballistics_core(u, zi, at, rt):
    """The attack/release smoother alone, from per-row initial states.
    Streaming carries ``y[:, -1]`` into the next call's ``zi``; split
    calls equal one call bit for bit.

    Differentiable in every argument.  Without grad it launches the
    primal walk (replaces ``_kernel``); with grad it runs
    :func:`ballistics_fwd` and, backward, :func:`ballistics_bwd`.

    Args:
        u: ``(N, L)`` input envelopes.
        zi, at, rt: ``(N,)`` initial states and attack / release factors.

    Returns:
        ``(N, L)`` smoothed envelopes.
    """
    if torch.is_grad_enabled() and any(a.requires_grad for a in (u, zi, at, rt)):
        return _Ballistics.apply(u, zi, at, rt)
    _device(u, "ballistics_core")
    return torch.ops.grafx_tpu_torch.ballistics(u, (zi, at, rt))


@torch.library.custom_op("grafx_tpu_torch::ballistics", mutates_args=())
def _walk_op(u: torch.Tensor, consts: Sequence[torch.Tensor]) -> torch.Tensor:
    """#7 as a custom op; ``consts`` = (zi, at, rt)."""
    return ballistics_plain(u, *consts)


@_walk_op.register_kernel("cuda")
def _walk_op_cuda(u, consts):
    y = _walk_fwd_cuda("ballistics_core", u, consts, res=False)
    ballistics_core.launches += 1
    return y


@_walk_op.register_fake
def _walk_op_fake(u, consts):
    return torch.empty_like(u)


def _walk_fwd_cuda(name, u, consts, res, samples=None):
    """#7 (``res`` False: ``y``) or #8 (``(y, d)``) on the card, the
    walk's stage of ``samples`` (:func:`walk_samples`)."""
    (u,) = _rows(name, u)
    c = _consts(name, u, *consts)
    y = torch.empty_like(u)
    d = torch.empty_like(u) if res else None
    _run(name, "grafx_ballistics_fwd", u, u.data_ptr(), y.data_ptr(), _ptr(d), c.data_ptr(),
         u.shape[0], u.shape[1], walk_samples(u.shape[1], samples))
    return (y, d) if res else y


def ballistics_fwd(u, zi, at, rt):
    """The walk plus the adjoint's residual (replaces ``_fwd_d_kernel``).

    Returns:
        ``(y, d)``: ``(N, L)`` smoothed envelopes and ``d = u - y[n-1]``
        (``y[-1] = zi``), which holds the attack/release decisions
        (``d > 0``) and the factor of the coefficients' gradients.
    """
    name = "ballistics_fwd"
    if _device(u, name) == "cpu":
        return ballistics_fwd_plain(u, zi, at, rt)
    out = _walk_fwd_cuda(name, u, (zi, at, rt), res=True)
    ballistics_fwd.launches += 1
    return out


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
    chunk = _walk_chunk(d, chunk)
    if _device(d, name) == "cpu":
        return ballistics_bwd_plain(d, g, at, rt)
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
    ballistics_bwd.launches += 1
    return (du, *grads.unbind(0))


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
    chunk = _walk_chunk(a, chunk)
    if _device(a, name) == "cpu":
        return reverse_scan_plain(a, g)
    a, g = _rows(name, a, g)
    gh = torch.empty_like(g)
    carry = _carry(a, chunk)
    _run(name, "grafx_reverse_scan", a, a.data_ptr(), g.data_ptr(), gh.data_ptr(),
         _ptr(carry), a.shape[0], a.shape[1], chunk)
    reverse_scan.launches += 1
    return gh


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

    Args:
        u: ``(N, L)`` energy envelopes.
        consts: ``(8 M, N)``: member i's rows :data:`CHAIN_ROWS` at 8 i.
        zi: ``(R, N)`` initial state of each walk, in the order of
            :func:`chain_walks` (1.0 for ballistics and a gain, 0.0 for
            the one-pole; a stream carries the final states).
        spec: per member ``(kind, smooth)``: ``"compressor"`` or
            ``"noisegate"``, and ``None``, ``"linear"`` or ``"log"``.

    Returns:
        ``(gain, last)``: ``(N, L)`` gains and ``(R, N)`` final states.
    """
    spec = tuple((kind, smooth) for kind, smooth in spec)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (u, consts, zi)):
        return _Chain.apply(u, consts, zi, spec)
    _device(u, "ballistics_chain_core")
    return torch.ops.grafx_tpu_torch.ballistics_chain(u, consts, zi, chain_code(spec))


@torch.library.custom_op("grafx_tpu_torch::ballistics_chain", mutates_args=())
def _chain_op(u: torch.Tensor, consts: torch.Tensor, zi: torch.Tensor,
              code: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain's primal as a custom op; ``code``: :func:`chain_code`."""
    return ballistics_chain_plain(u, consts, zi, chain_spec(code))


@_chain_op.register_kernel("cuda")
def _chain_op_cuda(u, consts, zi, code):
    out = _chain_fwd_cuda("ballistics_chain_core", u, consts, zi, chain_spec(code), res=False)
    ballistics_chain_core.launches += 1
    return out


@_chain_op.register_fake
def _chain_op_fake(u, consts, zi, code):
    return torch.empty_like(u), torch.empty_like(zi)


def _chain_args(name, u, consts, zi, spec):
    """Validate the chain's operands for the card; returns them
    contiguous with the spec's code."""
    (u,) = _rows(name, u)
    n, walks = u.shape[0], len(chain_walks(spec))
    for label, a, rows in (("consts", consts, len(CHAIN_ROWS) * len(spec)), ("zi", zi, walks)):
        if a.dtype != torch.float32 or a.shape != (rows, n) or a.device != u.device:
            raise ValueError(f"{name}: {label} must be a float32 ({rows}, {n}) tensor on {u.device},"
                             f" got {a.dtype} {tuple(a.shape)} on {a.device}")
    return u, consts.contiguous(), zi.contiguous(), chain_code(spec)


def _chain_fwd_cuda(name, u, consts, zi, spec, res, samples=None):
    """The chain's primal (``res`` False: ``(gain, last)``) or its forward
    with residuals (``(gain, d, last)``) on the card, the walks' stage of
    ``samples`` (:func:`walk_samples`)."""
    u, c, zi, code = _chain_args(name, u, consts, zi, spec)
    n, length = u.shape
    gain, last = torch.empty_like(u), u.new_empty(zi.shape)
    d = u.new_empty(zi.shape[0], n, length) if res else None
    _run(name, "grafx_chain_fwd", u, u.data_ptr(), gain.data_ptr(), _ptr(d), last.data_ptr(),
         c.data_ptr(), zi.data_ptr(), n, length, code, walk_samples(length, samples))
    return (gain, d, last) if res else (gain, last)


def ballistics_chain_fwd(u, consts, zi, spec):
    """The chain plus the adjoint's residuals.

    Returns:
        ``(gain, d, last)``: ``(N, L)`` gains, ``(R, N, L)`` residuals
        ``d = x - y[n-1]`` of each walk (input ``x``, output ``y``) and
        the ``(R, N)`` final states.
    """
    name = "ballistics_chain_fwd"
    if _device(u, name) == "cpu":
        return ballistics_chain_fwd_plain(u, consts, zi, spec)
    out = _chain_fwd_cuda(name, u, consts, zi, spec, res=True)
    ballistics_chain_fwd.launches += 1
    return out


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
    chunk = _walk_chunk(u, chunk)
    if _device(u, name) == "cpu":
        return ballistics_chain_bwd_plain(u, d, last, gg, consts, spec)
    u, gg = _rows(name, u, gg)
    u, c, last, code = _chain_args(name, u, consts, last, spec)
    if d.dtype != torch.float32 or d.shape != (last.shape[0], *u.shape) or d.device != u.device:
        raise ValueError(f"{name}: d must be a float32 {(last.shape[0], *u.shape)} tensor on {u.device}")
    d = d.contiguous()
    n, length = u.shape
    du = torch.empty_like(u)
    grads = u.new_empty(c.shape[0] + last.shape[0], n)
    scratch = u.new_empty(2 * len(spec), n, length)
    partials = u.new_empty(c.shape[0], n, _tiles(u))
    carry = _carry(u, chunk)
    _run(name, "grafx_chain_bwd", u, u.data_ptr(), d.data_ptr(), last.data_ptr(), gg.data_ptr(),
         c.data_ptr(), du.data_ptr(), grads.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
         _ptr(carry), n, length, chunk, code)
    ballistics_chain_bwd.launches += 1
    return du, grads[: c.shape[0]], grads[c.shape[0]:]


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
)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0
del _w


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts():
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _Gain(torch.autograd.Function):
    """:func:`ballistics_gain_core` with the ``custom_vjp`` of
    ``grafx_tpu.ops.ballistics.ballistics_gain_core``."""

    @staticmethod
    def forward(ctx, u, zi, at, rt, th, cf, hk, kind):
        gain, d, y_last = ballistics_gain_fwd(u, zi, at, rt, th, cf, hk, kind)
        ctx.save_for_backward(u, d, y_last, at, rt, th, cf, hk)
        ctx.kind = kind
        return gain

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        u, d, y_last, *consts = ctx.saved_tensors
        return (*ballistics_gain_bwd(u, d, y_last, gg, *consts, kind=ctx.kind), None)


class _GainPair(torch.autograd.Function):
    """:func:`ballistics_gain_pair_core` with the ``custom_vjp`` of
    ``grafx_tpu.ops.ballistics.ballistics_gain_pair_core``."""

    @staticmethod
    def forward(ctx, u, *args):
        *consts, kinds, inits = args
        gain, d_a, d_b, v_last, u_last = ballistics_gain_pair_fwd(
            u, *consts, kinds=kinds, inits=inits
        )
        ctx.save_for_backward(u, d_a, d_b, v_last, u_last, *consts)
        ctx.kinds = kinds
        return gain

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        u, d_a, d_b, v_last, u_last, *consts = ctx.saved_tensors
        grads = ballistics_gain_pair_bwd(
            u, d_a, d_b, v_last, u_last, gg, *consts, kinds=ctx.kinds
        )
        return (*grads, None, None)


class _Chain(torch.autograd.Function):
    """:func:`ballistics_chain_core` under gradient: the forward saves the
    residuals of every walk, the backward is the chain's adjoint.  The
    final states are no differentiable output."""

    @staticmethod
    def forward(ctx, u, consts, zi, spec):
        gain, d, last = ballistics_chain_fwd(u, consts, zi, spec)
        ctx.save_for_backward(u, d, last, consts)
        ctx.spec = spec
        ctx.mark_non_differentiable(last)
        return gain, last

    @staticmethod
    @once_differentiable
    def backward(ctx, gg, _):
        u, d, last, consts = ctx.saved_tensors
        du, dconsts, dzi = ballistics_chain_bwd(u, d, last, gg, consts, ctx.spec)
        return du, dconsts, dzi, None


class _Ballistics(torch.autograd.Function):
    """:func:`ballistics_core` with the ``custom_vjp`` of
    ``grafx_tpu.ops.ballistics.ballistics_core``: the forward saves only
    ``d`` (with ``at`` and ``rt``), neither ``u`` nor ``y``."""

    @staticmethod
    def forward(ctx, u, zi, at, rt):
        y, d = ballistics_fwd(u, zi, at, rt)
        ctx.save_for_backward(d, at, rt)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        d, at, rt = ctx.saved_tensors
        return ballistics_bwd(d, g, at, rt)
