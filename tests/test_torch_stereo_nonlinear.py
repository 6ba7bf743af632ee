"""The stereo tools and the nonlinear distortions: each class and option
of grafx_tpu_torch against grafx_tpu on the same numpy inputs and
parameters, ChebyshevDistortion also against numpy's Chebyshev series,
and gradients against jax.grad, at random inputs and at inputs that are
exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.polynomial import chebyshev

from grafx_tpu import processors as jp
from grafx_tpu_torch import processors as tp

L = 2**12
B = 3
REL = 1e-5  # rel. to max|ref|: elementwise float32 ops
GRAD_REL = 1e-4  # rel. to max|ref| of a gradient leaf (sums over time)

CASES = [
    pytest.param("SideGainImager", {}, 2, id="SideGainImager"),
    pytest.param("MonoToStereo", {}, 1, id="MonoToStereo"),
    pytest.param("StereoToMidSide", {}, 2, id="StereoToMidSide"),
    pytest.param("StereoToMidSide", {"normalize": False}, 2, id="StereoToMidSide-raw"),
    pytest.param("PiecewiseTanhDistortion", {}, 2, id="PiecewiseTanh"),
    pytest.param("PiecewiseTanhDistortion", {"inverse_post_gain": False}, 2,
                 id="PiecewiseTanh-post_gain"),
    pytest.param("PiecewiseTanhDistortion", {"pre_post_gain": False, "remove_dc": True}, 2,
                 id="PiecewiseTanh-dc"),
    pytest.param("PowerDistortion", {}, 2, id="Power"),
    pytest.param("PowerDistortion", {"max_order": 4, "use_tanh": True, "remove_dc": True}, 2,
                 id="Power-tanh-dc"),
    pytest.param("PowerDistortion", {"pre_gain": False}, 2, id="Power-no_gain"),
    pytest.param("ChebyshevDistortion", {}, 2, id="Chebyshev"),
    pytest.param("ChebyshevDistortion", {"max_order": 5, "use_tanh": True, "remove_dc": True}, 2,
                 id="Chebyshev-tanh-dc"),
    pytest.param("ChebyshevDistortion", {"pre_gain": False}, 2, id="Chebyshev-no_gain"),
]


def max_rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(np.asarray(ref)).max(), 1e-30)


def both(name, kwargs):
    return getattr(jp, name)(**kwargs), getattr(tp, name)(**kwargs)


def inputs(proc, channels, seed=0, zero=False):
    rng = np.random.default_rng(seed)
    x = (0.7 * rng.standard_normal((B, channels, L))).astype(np.float32)
    if zero:
        x[:, :, ::3] = 0.0
    p = {k: (0.5 * rng.standard_normal((B, v))).astype(np.float32)
         for k, v in proc.parameter_size().items()}
    return x, p


def outputs(out):
    return list(out) if isinstance(out, list) else [out]


@pytest.mark.parametrize("name, kwargs, channels", CASES)
def test_matches_grafx_tpu(name, kwargs, channels):
    jproc, tproc = both(name, kwargs)
    assert jproc.parameter_size() == tproc.parameter_size()
    x, p = inputs(tproc, channels)
    ref = outputs(jproc(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()}))
    got = outputs(tproc(torch.tensor(x), **{k: torch.tensor(v) for k, v in p.items()}))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert max_rel(g.detach().numpy(), r) <= REL, max_rel(g.detach().numpy(), r)


@pytest.mark.parametrize("normalize", [True, False])
def test_mid_side_to_stereo_matches_grafx_tpu_and_inverts(normalize):
    """The two-inlet MidSideToStereo against grafx_tpu's, and the round
    trip through StereoToMidSide (normalized: the identity)."""
    rng = np.random.default_rng(1)
    mid, side = (rng.standard_normal((B, 1, L)).astype(np.float32) for _ in range(2))
    ref = jp.MidSideToStereo(normalize)(jnp.asarray(mid), jnp.asarray(side))
    got = tp.MidSideToStereo(normalize)(torch.tensor(mid), torch.tensor(side))
    assert max_rel(got.numpy(), ref) <= REL
    x = torch.tensor(rng.standard_normal((B, 2, L)).astype(np.float32))
    back = tp.MidSideToStereo()(*tp.StereoToMidSide()(x))
    assert max_rel(back.numpy(), x.numpy()) <= REL


def test_chebyshev_matches_numpy_chebyshev_series():
    """The bound of tests/processors/test_oracles.py:301 (rtol 1e-3, atol
    1e-4) against numpy.polynomial.chebyshev in float64."""
    K = 6
    dist = tp.ChebyshevDistortion(max_order=K, pre_gain=False)
    rng = np.random.RandomState(1)
    x = (0.9 * np.tanh(rng.randn(2, 2, 1000))).astype(np.float32)
    w = rng.randn(2, K).astype(np.float32) * 0.3
    out = dist(torch.tensor(x), basis_weights=torch.tensor(w)).numpy()
    for b in range(2):
        expected = chebyshev.chebval(x[b].astype(np.float64), np.tanh(w[b].astype(np.float64)))
        np.testing.assert_allclose(out[b], expected, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("zero", [False, True], ids=["random", "zeros"])
@pytest.mark.parametrize("name, kwargs, channels", CASES)
def test_gradients_match_jax_grad(name, kwargs, channels, zero):
    """d sum(y^2) / d (x, every parameter) against jax.grad, also where a
    third of the input samples are exactly 0.  There PowerDistortion's
    derivative is that of its k = 0 and k = 1 powers, 0 and 1, and the
    port's gradient is finite.  JAX's is NaN at those samples (its pow's
    JVP forms k x^(k-1), 0 * inf at k = 0, x = 0), and with it the pre-gain's;
    the reference there is jax.grad at 1e-30 in place of each exact 0, the
    derivative's limit from the right."""
    jproc, tproc = both(name, kwargs)
    x, p = inputs(tproc, channels, seed=2, zero=zero)

    def loss(x, params):
        return sum(jnp.sum(o ** 2) for o in outputs(jproc(x, **params)))

    def jax_grads(x):
        return jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}
        )

    ref_x, ref_p = jax_grads(x)
    if not np.isfinite(np.asarray(ref_x)).all():
        assert name == "PowerDistortion" and zero
        ref_x, ref_p = jax_grads(np.where(x == 0, np.float32(1e-30), x))
    tx = torch.tensor(x, requires_grad=True)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    sum(torch.sum(o ** 2) for o in outputs(tproc(tx, **params))).backward()
    for k, got, want in [("x", tx.grad, ref_x)] + [(k, params[k].grad, ref_p[k]) for k in p]:
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all() and np.isfinite(want).all(), k
        assert max_rel(got, want) <= GRAD_REL, (k, max_rel(got, want))


def test_stereo_tools_refuse_wrong_channel_counts():
    with pytest.raises(ValueError, match="2-channel"):
        tp.SideGainImager()(torch.zeros(1, 1, 8), torch.zeros(1, 1))
    with pytest.raises(ValueError, match="1-channel"):
        tp.MonoToStereo()(torch.zeros(1, 2, 8))
    with pytest.raises(ValueError, match="max_order"):
        tp.PowerDistortion(max_order=1)
