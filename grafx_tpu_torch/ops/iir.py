"""Exact blocked IIR (biquad cascade) filtering, differentiable.

The port of the exact path of :mod:`grafx_tpu.ops.iir`: the signal is
split into blocks of length ``T``; inside a block the zero-state response
is a matmul against the causal Toeplitz operator of the exactly computed
length-``T`` truncated impulse response; the state handed to the next
block is a linear function of the incoming state and the block's
samples, propagated across the ``L / T`` blocks by prefix doubling.
Cascades of 3+ biquads run as ONE blocked linear system with a ``2K``-dim
state, its kernels assembled by log-depth pairwise composition.  The
numerics rationale (eigenbasis coordinates, compensated discriminant)
is documented at the JAX counterparts of each function.  Gradients run
through torch autograd, except the cross-block state propagation, which
carries the JAX package's hand-written adjoint (:class:`_PropagateStates`).
The exact one-pole smoother (:func:`onepole_exact`) is the first-order
case with a scalar state.  Both carry their state across calls for
block-wise streaming (``state_in``/``return_state``).

Exact to float32: every contraction must run in full float32.  On a GPU
that means no TF32 (``torch.backends.cuda.matmul.allow_tf32`` False);
the data path refuses to run otherwise.

The frequency-sampling (FSM) approximation, the default backend of
``IIRFilter`` in both packages, samples the cascade's DTFT at
``fir_len // 2 + 1`` bins and takes the FIR by an inverse real FFT
(:func:`iir_fsm_fir`); :func:`biquad_scan` is the sequential test oracle.
"""

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from grafx_tpu_torch.ops.fftconv import fft_convolve, next_pow2

# Toeplitz ZSR memory is N*T^2 floats; beyond this block length the
# zero-state response is an FFT convolution.
_TOEPLITZ_MAX_T = 256


def _require_full_fp32(x):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the exact IIR path needs full float32 matmuls; set"
            " torch.backends.cuda.matmul.allow_tf32 = False"
        )


def exactness_check_db(L=2**15, N=4, K=24, r_hi=0.999, seed=0, device="cpu"):
    """Exact-cascade error vs a float64 scipy oracle on ``device``, in dB
    (target <= -60): CPU tests cannot see a device's matmul precision,
    so run this on the device before trusting its renders."""
    import numpy as np
    from scipy import signal as ss

    rng = np.random.RandomState(seed)
    r = rng.uniform(0.2, r_hi, (N, K))
    th = rng.uniform(0.02, np.pi - 0.02, (N, K))
    As = np.stack([np.ones_like(r), -2 * r * np.cos(th), r**2], -1)
    Bs = rng.randn(N, K, 3)
    x = rng.randn(N, L)
    y_ref = x.astype(np.float64)
    for n in range(N):
        yn = y_ref[n]
        for k in range(K):
            yn = ss.lfilter(Bs[n, k], As[n, k], yn)
        y_ref[n] = yn

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    y = biquad_exact(t(x), t(Bs), t(As)).cpu().numpy().astype(np.float64)
    err = y - y_ref
    return float(
        10.0 * np.log10(np.mean(err**2) / (np.mean(y_ref**2) + 1e-300) + 1e-300)
    )


# ---------------------------------------------------------------------------
# Frequency-sampling method (FSM)
# ---------------------------------------------------------------------------


def fsm_delay_phasors(order, fir_len, device=None):
    """DFT-bin phasors ``exp(-j w k)`` for delays ``k = 0..order``, shape
    ``(order + 1, fir_len // 2 + 1)``: the phase in float32, in
    ``grafx_tpu``'s order of operations, then a complex64 ``exp``."""
    k = torch.arange(order + 1, dtype=torch.float32, device=device)[:, None]
    bins = torch.arange(fir_len // 2 + 1, dtype=torch.float32, device=device)[None, :]
    phase = 2.0 * math.pi * k * bins / fir_len
    return torch.exp(-1j * phase)


def iir_fsm_response(Bs, As, delays):
    """Sampled DTFT ``(..., K, F)`` of each biquad of ``(..., K, 3)``
    coefficient stacks, from :func:`fsm_delay_phasors` ``(3, F)``."""
    num = torch.sum(Bs[..., None] * delays, dim=-2)
    den = torch.sum(As[..., None] * delays, dim=-2)
    return num / den


def _product_over_sections(response):
    """``prod`` over the section axis (-2) as a pairwise tree of
    multiplies: ``torch.prod``'s backward reads a zero count on the host,
    which a CUDA-graph capture refuses."""
    while response.shape[-2] > 1:
        even = response.shape[-2] // 2 * 2
        paired = response[..., 0:even:2, :] * response[..., 1:even:2, :]
        response = torch.cat([paired, response[..., even:, :]], dim=-2)
    return response[..., 0, :]


def iir_fsm_fir(Bs, As, fir_len):
    """The FIR ``(..., fir_len)`` that frequency-samples the biquad cascade
    ``(..., K, 3)`` at ``fir_len // 2 + 1`` bins (its time-aliased impulse
    response); differentiable through torch's complex autograd."""
    delays = fsm_delay_phasors(2, fir_len, device=Bs.device)
    response = _product_over_sections(iir_fsm_response(Bs, As, delays))
    return torch.fft.irfft(response, n=fir_len)


# ---------------------------------------------------------------------------
# Exact sequential scan (the correctness oracle; tests only)
# ---------------------------------------------------------------------------


def _normalize(Bs, As):
    return Bs / As[..., :1], As / As[..., :1]


def biquad_scan(x, Bs, As):
    """The biquad cascade by a plain loop over time (transposed direct
    form II), one section after another: slow and exact, the test oracle
    of the other backends.  ``x`` is ``(N, L)``, ``Bs``/``As`` ``(N, K,
    3)`` (un-normalized allowed)."""
    b, a = _normalize(Bs, As)
    y = x
    for k in range(b.shape[-2]):
        b0, b1, b2 = b[:, k, 0], b[:, k, 1], b[:, k, 2]
        a1, a2 = a[:, k, 1], a[:, k, 2]
        s1 = s2 = torch.zeros_like(y[:, 0])
        out = []
        for n in range(y.shape[-1]):
            xn = y[:, n]
            yn = b0 * xn + s1
            s1, s2 = b1 * xn - a1 * yn + s2, b2 * xn - a2 * yn
            out.append(yn)
        y = torch.stack(out, dim=-1)
    return y


def _compensated_disc(a1, a2):
    """``a1**2 - 4*a2`` with the squaring's rounding error compensated
    (Dekker split product; see ``grafx_tpu.ops.iir._compensated_disc``)."""
    splitter = 134217729.0 if a1.dtype == torch.float64 else 4097.0
    c = a1 * splitter
    hi = c - (c - a1)
    lo = a1 - hi
    p = a1 * a1
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo  # exact a1*a1 - p
    return (p - 4.0 * a2) + err


def _cum_powers(re0, im0, T):
    """Complex cumulative powers ``l^n`` for ``n = 1..T`` of per-row
    eigenvalues ``l = re0 + i im0`` -> ``(re, im)`` tensors ``(M, T)``, by
    doubling: the length-``2^k`` prefix times its own last element
    appends the next ``2^k`` powers."""
    pr, pi = re0[:, None], im0[:, None]
    while pr.shape[1] < T:
        sr, si = pr[:, -1:], pi[:, -1:]
        nr = pr * sr - pi * si
        ni = pr * si + pi * sr
        pr = torch.cat([pr, nr], dim=1)
        pi = torch.cat([pi, ni], dim=1)
    return pr[:, :T], pi[:, :T]


def _stage_eigen_kernels(bk, ak, T):
    """Blocked state-space kernels for one biquad in the pole pair's
    eigenbasis (complex pair: scaled rotation; separated real poles:
    diagonal; near-double real poles: Jordan block), selected per row by
    the compensated discriminant.

    Args:
        bk, ak: ``(N, 3)`` normalized biquad coefficients.
        T: block length.

    Returns:
        ``(h, K_out, K_in, M)``: ``h (N, T)`` truncated impulse response;
        ``K_out (N, 2, T)`` initial-state response kernels; ``K_in (N, 2,
        T)`` state-injection kernels; ``M (N, 2, 2)`` block transition.
    """
    N = ak.shape[0]
    dtype = ak.dtype
    tiny = 1e-300 if dtype == torch.float64 else 1e-30

    b0, b1, b2 = bk[:, 0], bk[:, 1], bk[:, 2]
    a1, a2 = ak[:, 1], ak[:, 2]
    c0, c1 = b1 - b0 * a1, b2 - b0 * a2  # C vector

    disc = _compensated_disc(a1, a2)
    mu = -0.5 * a1
    dim = 0.5 * torch.sqrt(torch.clamp_min(-disc, tiny))  # Im(l), complex case
    delta = 0.5 * torch.sqrt(torch.clamp_min(disc, tiny))  # (l1 - l2)/2, real
    is_complex = disc < 0
    jtol = 1e-14 if dtype == torch.float64 else 1e-6
    is_jordan = (~is_complex) & (delta <= jtol * torch.abs(mu))

    # cumulative powers n = 1..T;
    # rows = [l_c = mu + i dim | l1 = mu + delta | l2 = mu - delta]
    l1 = mu + delta
    l2 = mu - delta
    re0 = torch.cat([mu, l1, l2])
    im0 = torch.cat([dim, torch.zeros_like(l1), torch.zeros_like(l2)])
    Pr, Pi = _cum_powers(re0, im0, T)
    one = torch.ones((N, 1), dtype=dtype, device=ak.device)
    zero = torch.zeros((N, 1), dtype=dtype, device=ak.device)
    xs = torch.cat([one, Pr[:N]], dim=1)  # Re l_c^n, n = 0..T
    ys = torch.cat([zero, Pi[:N]], dim=1)  # Im l_c^n
    u = torch.cat([one, Pr[N : 2 * N]], dim=1)  # l1^n
    v = torch.cat([one, Pr[2 * N :]], dim=1)  # l2^n

    def rev(a):
        return torch.flip(a, dims=[-1])

    # --- complex pair
    dim_s = torch.clamp_min(dim, tiny)
    C1c = ((c0 * mu + c1) / dim_s)[:, None]
    C2c = c0[:, None]
    Koc0 = C1c * xs[:, :T] - C2c * ys[:, :T]
    Koc1 = C1c * ys[:, :T] + C2c * xs[:, :T]
    Kic0 = rev(ys[:, :T])
    Kic1 = rev(xs[:, :T])
    Mc = torch.stack(
        [
            torch.stack([xs[:, T], ys[:, T]], -1),
            torch.stack([-ys[:, T], xs[:, T]], -1),
        ],
        dim=-2,
    )
    hc = torch.cat([b0[:, None], Koc1[:, : T - 1]], dim=-1)

    # --- separated real poles
    sq_s = torch.clamp_min(2.0 * delta, tiny)
    C1r = ((c0 * l1 + c1) / sq_s)[:, None]
    C2r = ((c0 * l2 + c1) / sq_s)[:, None]
    Kor0 = C1r * u[:, :T]
    Kor1 = C2r * v[:, :T]
    Kir0 = rev(u[:, :T])
    Kir1 = -rev(v[:, :T])
    zcol = torch.zeros_like(u[:, T])
    Mr = torch.stack(
        [
            torch.stack([u[:, T], zcol], -1),
            torch.stack([zcol, v[:, T]], -1),
        ],
        dim=-2,
    )
    hr = torch.cat([b0[:, None], (Kor0 - Kor1)[:, : T - 1]], dim=-1)

    # --- near-double real poles (Jordan basis)
    m_pow = xs  # m^n, n = 0..T
    m_prev = torch.cat([zero, xs[:, :T]], dim=1)  # m^(n-1)
    narr = torch.arange(T + 1, dtype=dtype, device=ak.device)[None, :]
    nm = narr * m_prev  # n m^(n-1); n = 0 entry is 0
    C1j = (c0 * mu + c1)[:, None]
    C2j = c0[:, None]
    Koj0 = C1j * m_pow[:, :T]
    Koj1 = C1j * nm[:, :T] + C2j * m_pow[:, :T]
    Kij0 = rev(nm[:, :T])
    Kij1 = rev(m_pow[:, :T])
    Mj = torch.stack(
        [
            torch.stack([m_pow[:, T], nm[:, T]], -1),
            torch.stack([zcol, m_pow[:, T]], -1),
        ],
        dim=-2,
    )
    hj = torch.cat([b0[:, None], Koj1[:, : T - 1]], dim=-1)

    def sel(ndim_suffix, c, j, r_):
        shape = (N,) + (1,) * ndim_suffix
        return torch.where(
            is_complex.reshape(shape), c,
            torch.where(is_jordan.reshape(shape), j, r_),
        )

    h = sel(1, hc, hj, hr)
    K_out = sel(
        2,
        torch.stack([Koc0, Koc1], dim=1),
        torch.stack([Koj0, Koj1], dim=1),
        torch.stack([Kor0, Kor1], dim=1),
    )
    K_in = sel(
        2,
        torch.stack([Kic0, Kic1], dim=1),
        torch.stack([Kij0, Kij1], dim=1),
        torch.stack([Kir0, Kir1], dim=1),
    )
    M = sel(2, Mc, Mj, Mr)
    return h, K_out, K_in, M


def _causal_toeplitz(h):
    """``(N, T)`` causal IR -> ``(N, T, T)`` causal Toeplitz operator
    ``Op[n, q, t] = h[n, t - q]`` (zero below the anti-causal diagonal):
    row ``q`` of the ``2T``-periodic tiling of ``[h, 0]`` at stride
    ``2T - 1`` is ``[h, 0]`` rolled by ``q``."""
    N, T = h.shape
    z = torch.cat([h, torch.zeros_like(h)], dim=-1)  # (N, 2T)
    zt = z.repeat(1, T)[:, : T * (2 * T - 1)].reshape(N, T, 2 * T - 1)
    return zt[:, :, :T]


def _zero_state_response(xb, h, toeplitz):
    """Per-block zero-state response of ``(N, NB, T)`` blocks."""
    T = xb.shape[-1]
    if toeplitz is None and T <= _TOEPLITZ_MAX_T:
        toeplitz = _causal_toeplitz(h)
    if toeplitz is not None:
        return torch.einsum("nbq,nqt->nbt", xb, toeplitz)
    return fft_convolve(xb, h[:, None, :], mode="causal", pad_mode="pow2")


def _doubling(v, A, transpose):
    """Prefix doubling on ``(N, NB, S)`` vectors: ``v[k] += A^(2^l) v[k -
    2^l]`` (forward), or with ``A^T`` and ``v[k + 2^l]`` (its
    time-reversed transpose)."""
    num_blocks = v.shape[-2]
    out = v
    P = A
    shift = 1
    while shift < num_blocks:
        if transpose:
            shifted = F.pad(out, (0, 0, 0, shift))[..., shift:, :]
            out = out + torch.einsum("nji,nbj->nbi", P, shifted)
        else:
            shifted = F.pad(out, (0, 0, shift, 0))[..., :num_blocks, :]
            out = out + torch.einsum("nij,nbj->nbi", P, shifted)
        P = torch.bmm(P, P)
        shift *= 2
    return out


class _PropagateStates(torch.autograd.Function):
    """Cross-block state propagation with the hand-written adjoint of
    ``grafx_tpu.ops.iir._propagate_states`` (the linear-recurrence
    result), so that autograd never transposes the ``bmm(P, P)`` squaring
    chain:

        lambda[k] = g[k] + A^T lambda[k+1]   (reverse doubling)
        ds_in = lambda,   dA = sum_k lambda[k] s[k-1]^T
    """

    @staticmethod
    def forward(ctx, s_in, A):
        s = _doubling(s_in, A, transpose=False)
        ctx.save_for_backward(s, A)
        return s

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s, A = ctx.saved_tensors
        lam = _doubling(g, A, transpose=True)
        s_prev = torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)
        return lam, torch.einsum("nbi,nbj->nij", lam, s_prev)


def _propagate_states(s_in, A):
    """Cross-block state propagation ``s[k] = A s[k-1] + s_in[k]``
    (``s[-1] = 0``) for a constant per-item transition ``A (N, S, S)``, by
    prefix doubling on the ``(N, NB, S)`` vectors:
    ``s[k] += A^(2^l) s[k - 2^l]``."""
    return _PropagateStates.apply(s_in, A)


def _split_blocks(x, T, return_state=False):
    N, L = x.shape
    num_blocks = -(-L // T)
    pad = num_blocks * T - L
    if return_state and pad:
        # zero-padding a partial final block would evolve the carried
        # state past sample L
        raise ValueError(
            f"return_state requires the signal length ({L}) to be a"
            f" multiple of the block size ({T})."
        )
    xp = F.pad(x, (0, pad)) if pad else x
    return xp.reshape(N, num_blocks, T), num_blocks


def _carry_states(s_in, A, state_in):
    """``(s_after, s_enter)``: the state after and entering each block
    for per-block injections ``s_in (N, NB, S)``, transition ``A (N, S,
    S)`` and an optional incoming state ``state_in (N, S)`` (streaming;
    zero otherwise)."""
    if state_in is not None:
        s0 = s_in[:, :1] + torch.einsum("nij,nj->ni", A, state_in)[:, None]
        s_in = torch.cat([s0, s_in[:, 1:]], dim=1)
    s_after = _propagate_states(s_in, A)
    first = torch.zeros_like(s_after[:, :1]) if state_in is None else state_in[:, None]
    return s_after, torch.cat([first, s_after[:, :-1]], dim=1)


def _biquad_block_stage_apply(x, kernels, T, toeplitz=None, state_in=None, return_state=False):
    """One exact biquad on prebuilt :func:`_stage_eigen_kernels` kernels.

    ``state_in``/``return_state``: the ``(N, 2)`` eigenbasis state carried
    across calls (streaming); ``return_state`` requires ``L % T == 0``.
    """
    h, K_out, K_in, M = kernels
    N, L = x.shape
    xb, num_blocks = _split_blocks(x, T, return_state)
    y_zs = _zero_state_response(xb, h, toeplitz)
    s_in = torch.einsum("nbt,nst->nbs", xb, K_in)  # (N, NB, 2)
    s_after, s_enter = _carry_states(s_in, M, state_in)
    y_is = torch.einsum("nbs,nst->nbt", s_enter, K_out)
    y = (y_zs + y_is).reshape(N, num_blocks * T)[:, :L]
    return (y, s_after[:, -1]) if return_state else y


def _cascade_kernels_doubling(b, a, T):
    """Blocked-cascade operator kernels ``(H, W, V, A)`` by log-depth
    pairwise composition of per-stage eigenbasis kernels; composition of
    upstream group 1 with downstream group 2:

        H   = trunc(H1 * H2)
        V   = [trunc(V1 * H2); V2]
        W   = [W1; rev(trunc(H1 * rev(W2)))]
        A   = [[A1, 0], [V1 W2^T, A2]]

    K is padded to a power of two with identity stages (zero kernels).
    """
    N, K, _ = b.shape
    K_pad = 1 << max((K - 1).bit_length(), 0)

    h_f, K_out_f, K_in_f, M_f = _stage_eigen_kernels(
        b.reshape(N * K, 3), a.reshape(N * K, 3), T
    )
    h = h_f.reshape(N, K, T)
    CA = K_out_f.reshape(N, K, 2, T)  # per-state ISR signals
    W_stage = K_in_f.reshape(N, K, 2, T)  # per-state injection kernels
    AT = M_f.reshape(N, K, 2, 2)  # per-stage block transition

    if K_pad != K:
        pad_n = K_pad - K
        delta = h.new_zeros((N, pad_n, T))
        delta[..., 0].fill_(1.0)  # a fill: setitem would make a host tensor
        h = torch.cat([h, delta], dim=1)
        CA = torch.cat([CA, CA.new_zeros((N, pad_n, 2, T))], dim=1)
        W_stage = torch.cat([W_stage, W_stage.new_zeros((N, pad_n, 2, T))], dim=1)
        AT = torch.cat([AT, AT.new_zeros((N, pad_n, 2, 2))], dim=1)

    G = K_pad
    H, V, W, A = h, CA, W_stage, AT
    n2 = 2 * T

    def tconv_freq(Xf, Yf):
        return torch.fft.irfft(Xf * Yf, n=n2)[..., :T]

    while G > 1:
        H1, H2 = H[:, 0::2], H[:, 1::2]  # (N, G/2, T)
        V1, V2 = V[:, 0::2], V[:, 1::2]  # (N, G/2, R, T)
        W1, W2 = W[:, 0::2], W[:, 1::2]
        A1, A2 = A[:, 0::2], A[:, 1::2]  # (N, G/2, R, R)

        H1f = torch.fft.rfft(H1, n=n2)
        H2f = torch.fft.rfft(H2, n=n2)
        V1f = torch.fft.rfft(V1, n=n2)
        W2rf = torch.fft.rfft(torch.flip(W2, dims=[-1]), n=n2)

        H = tconv_freq(H1f, H2f)
        V1H2 = tconv_freq(V1f, H2f[..., None, :])
        W2c = torch.flip(tconv_freq(H1f[..., None, :], W2rf), dims=[-1])
        B = torch.einsum("ngst,ngrt->ngsr", W2, V1)  # (N, G/2, R2, R1)

        A = torch.cat(
            [
                torch.cat([A1, torch.zeros_like(B).transpose(-1, -2)], -1),
                torch.cat([B, A2], -1),
            ],
            dim=-2,
        )  # (N, G/2, 2R, 2R)
        V = torch.cat([V1H2, V2], dim=2)
        W = torch.cat([W1, W2c], dim=2)
        G //= 2

    H_cas, V, W, A_blk = H[:, 0], V[:, 0], W[:, 0], A[:, 0]
    S = 2 * K
    # identity-padding stages sit at the end of the cascade: drop their
    # trailing state rows
    return H_cas, W[:, :S], V[:, :S], A_blk[:, :S, :S]


def _biquad_block_cascade_apply(x, kernels, T, toeplitz=None, state_in=None,
                                return_state=False):
    """Single-pass blocked cascade on prebuilt
    :func:`_cascade_kernels_doubling` kernels: (1) zero-state response,
    (2) per-block state injection, (3) cross-block propagation, (4)
    initial-state responses.  ``state_in``/``return_state`` thread the
    ``(N, S)`` eigenbasis state across calls (streaming); ``return_state``
    requires ``L % T == 0``."""
    H_cas, W, V, A_blk = kernels
    N, L = x.shape
    xb, num_blocks = _split_blocks(x, T, return_state)
    y_zs = _zero_state_response(xb, H_cas, toeplitz)
    s_in = torch.einsum("nbt,nst->nbs", xb, W)  # (N, NB, S)
    s_after, s_enter = _carry_states(s_in, A_blk, state_in)
    y_is = torch.einsum("nbs,nst->nbt", s_enter, V)
    y = (y_zs + y_is).reshape(N, num_blocks * T)[:, :L]
    return (y, s_after[:, -1]) if return_state else y


def _biquad_block_cascade(x, b, a, T):
    """Exact cascade of normalized ``(N, K, 3)`` biquads on ``(N, L)``."""
    return _biquad_block_cascade_apply(x, _cascade_kernels_doubling(b, a, T), T)


def biquad_exact(x, Bs, As, block_size: int = 128):
    """Exact biquad cascade via the blocked state-space method.

    Args:
        x: ``(N, L)`` signals.
        Bs, As: ``(N, K, 3)`` (un-normalized allowed).
        block_size: block length ``T``; clamped to ``next_pow2(L)``.
    """
    _require_full_fp32(x)
    L = x.shape[-1]
    T = min(block_size, next_pow2(L))
    b, a = _normalize(Bs, As)
    if b.shape[-2] <= 2:
        y = x
        for k in range(b.shape[-2]):
            y = _biquad_block_stage_apply(
                y, _stage_eigen_kernels(b[:, k], a[:, k], T), T
            )
        return y
    return _biquad_block_cascade(x, b, a, T)


def biquad_exact_build(Bs, As, block_size: int = 128):
    """Build the parameter-dependent kernels of :func:`biquad_exact` once
    (the ``precompute`` processor hook): a dict of tensors with leading
    dim ``N``, sliceable per node batch."""
    b, a = _normalize(Bs, As)
    K = b.shape[-2]
    T = block_size
    if K <= 2:
        ks = [_stage_eigen_kernels(b[:, k], a[:, k], T) for k in range(K)]
        cache = {
            "h": torch.stack([k_[0] for k_ in ks], 1),
            "K_out": torch.stack([k_[1] for k_ in ks], 1),
            "K_in": torch.stack([k_[2] for k_ in ks], 1),
            "M": torch.stack([k_[3] for k_ in ks], 1),
        }
        if T <= _TOEPLITZ_MAX_T:
            cache["Toep"] = torch.stack([_causal_toeplitz(k_[0]) for k_ in ks], 1)
        return cache
    H, W, V, A = _cascade_kernels_doubling(b, a, T)
    cache = {"H": H, "W": W, "V": V, "A": A}
    if T <= _TOEPLITZ_MAX_T:
        cache["Toep"] = _causal_toeplitz(H)
    return cache


def biquad_exact_apply(x, cache, block_size: int = 128, state_in=None, return_state=False):
    """Apply kernels from :func:`biquad_exact_build` to ``(N, L)``
    signals (exact for any ``L``).

    ``state_in``/``return_state`` carry the filter state across calls for
    block-wise streaming (``return_state`` requires ``L`` to be a multiple
    of ``block_size``).  The state is ``(N, 2 K)`` for the single-pass
    cascade, ``(N, K, 2)`` for the per-stage path;
    :func:`biquad_exact_zero_state` builds the initial zeros.
    """
    _require_full_fp32(x)
    T = block_size
    toep = cache.get("Toep")
    if "H" in cache:
        return _biquad_block_cascade_apply(
            x, (cache["H"], cache["W"], cache["V"], cache["A"]), T, toeplitz=toep,
            state_in=state_in, return_state=return_state,
        )
    y = x
    states_out = []
    for k in range(cache["h"].shape[1]):
        kernels = tuple(cache[n][:, k] for n in ("h", "K_out", "K_in", "M"))
        out = _biquad_block_stage_apply(
            y, kernels, T, toeplitz=None if toep is None else toep[:, k],
            state_in=None if state_in is None else state_in[:, k],
            return_state=return_state,
        )
        if return_state:
            y, s_k = out
            states_out.append(s_k)
        else:
            y = out
    return (y, torch.stack(states_out, dim=1)) if return_state else y


def biquad_exact_zero_state(cache, num_signals):
    """Zero initial state in ``cache``'s layout for streaming with
    :func:`biquad_exact_apply`."""
    if "H" in cache:
        w = cache["W"]
        return w.new_zeros((num_signals, w.shape[-2]))
    h = cache["h"]
    return h.new_zeros((num_signals, h.shape[1], 2))


def onepole_exact(x, alpha, block_size: int = 1024, state_in=None, return_state=False):
    """Exact one-pole smoother ``y[n] = alpha y[n-1] + (1 - alpha) x[n]``,
    blocked like :func:`biquad_exact` with a scalar state whose powers
    are in closed form.

    Args:
        x: ``(N, L)``.
        alpha: ``(N,)`` in ``(0, 1)``.
        block_size: block length; clamped to ``next_pow2(L)``.
        state_in: optional ``(N,)`` previous output sample ``y[-1]``
            (streaming continuation; zero otherwise).
        return_state: also return ``y[:, -1]``, the state the next call
            continues from.
    """
    _require_full_fp32(x)
    N, L = x.shape
    T = min(block_size, next_pow2(L))
    xb, num_blocks = _split_blocks(x, T)

    log_alpha = torch.log(alpha)[:, None]  # (N, 1)
    n = torch.arange(T, dtype=x.dtype, device=x.device)[None, :]
    powers = torch.exp(log_alpha * n)  # alpha^n, (N, T)
    alpha_T = torch.exp(log_alpha[:, 0] * T)  # (N,)
    h = (1.0 - alpha)[:, None] * powers
    y_zs = fft_convolve(xb, h[:, None, :], mode="causal", pad_mode="pow2")

    # the state is y at the end of the previous block:
    # s_in[k] = sum_i alpha^(T-1-i) (1 - alpha) x[k, i]
    s_in = torch.einsum("nbt,nt->nb", xb, torch.flip(h, dims=[-1]))
    if state_in is not None:
        s_in = torch.cat([s_in[:, :1] + (alpha_T * state_in)[:, None], s_in[:, 1:]], dim=1)
    # scalar prefix doubling: s[k] = alpha^T s[k-1] + s_in[k]
    s_after, P, shift = s_in, alpha_T, 1
    while shift < num_blocks:
        shifted = F.pad(s_after, (shift, 0))[:, :num_blocks]
        s_after = s_after + P[:, None] * shifted
        P = P * P
        shift *= 2
    first = torch.zeros_like(s_after[:, :1]) if state_in is None else state_in[:, None]
    s_enter = torch.cat([first, s_after[:, :-1]], dim=1)

    y = y_zs + powers[:, None, :] * alpha[:, None, None] * s_enter[..., None]
    y = y.reshape(N, num_blocks * T)[:, :L]
    return (y, y[:, -1]) if return_state else y
