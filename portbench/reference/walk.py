"""The attack/release (ballistics) recursion, walked sample by sample in
NumPy on the host, with its adjoint for autograd:

    y[n] = y[n-1] + c[n] (u[n] - y[n-1]),  c[n] = at if u[n] > y[n-1] else rt

The attack/release decisions are constants under the gradient.  The
adjoint walks ``lam[n] = g[n] + (1 - c[n+1]) lam[n+1]`` back in time; the
input's cotangent is ``c lam`` and the coefficients' are the sums of
``(u - y[n-1]) lam`` over the attack and the release samples.
"""

import numpy as np
import torch


def walk(u, at, rt, y0, dtype=np.float64):
    """``(L, N)`` inputs, ``(N,)`` coefficients and initial states ->
    ``(y, d)``, the walk and its residual ``d[n] = u[n] - y[n-1]``."""
    y = np.empty_like(u, dtype=dtype)
    d = np.empty_like(u, dtype=dtype)
    st = np.asarray(y0, dtype=dtype).copy()
    at, rt = np.asarray(at, dtype=dtype), np.asarray(rt, dtype=dtype)
    for n in range(u.shape[0]):
        dn = u[n] - st
        st = st + np.where(dn > 0, at, rt) * dn
        d[n] = dn
        y[n] = st
    return y, d


def adjoint(g, d, at, rt):
    """``(du, dat, drt)`` for the walk's ``(L, N)`` output cotangent."""
    c = np.where(d > 0, at, rt)
    lam = np.empty_like(g)
    st = np.zeros(g.shape[1], dtype=g.dtype)
    keep = np.zeros(g.shape[1], dtype=g.dtype)
    for n in range(g.shape[0] - 1, -1, -1):
        st = g[n] + keep * st
        lam[n] = st
        keep = 1.0 - c[n]
    dl = d * lam
    attack = d > 0
    return c * lam, np.where(attack, dl, 0.0).sum(0), np.where(attack, 0.0, dl).sum(0)


class Walk(torch.autograd.Function):
    """``walk`` on ``(N, L)`` tensors of any device, through the host."""

    @staticmethod
    def forward(ctx, u, at, rt, y0):
        dtype = np.float64 if u.dtype == torch.float64 else np.float32
        un = np.ascontiguousarray(u.detach().cpu().numpy().T)
        y, d = walk(un, at.detach().cpu().numpy(), rt.detach().cpu().numpy(),
                    y0.detach().cpu().numpy(), dtype)
        ctx.d = d
        ctx.save_for_backward(at, rt)
        return torch.from_numpy(np.ascontiguousarray(y.T)).to(u.device)

    @staticmethod
    def backward(ctx, g):
        at, rt = ctx.saved_tensors
        gn = np.ascontiguousarray(g.detach().cpu().numpy().T)
        du, dat, drt = adjoint(gn, ctx.d, at.detach().cpu().numpy(), rt.detach().cpu().numpy())
        dev = g.device
        return (torch.from_numpy(np.ascontiguousarray(du.T)).to(dev),
                torch.from_numpy(dat).to(dev), torch.from_numpy(drt).to(dev), None)


def ballistics(u, at, rt, y0):
    return Walk.apply(u, at, rt, y0)
