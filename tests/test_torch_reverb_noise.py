"""The noise reverbs and the feedback delay network: each class of
grafx_tpu_torch against grafx_tpu on the same numpy inputs and parameters
and the same key (grafx_tpu_torch.random draws jax.random's bits), for
every processor_channel and with fade-in; the keyless host crop over
three eager calls; gradients against jax.grad; streams against the
one-shot forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch import random as tr

L = 2**13
B = 3
BLOCK = 1024
# rel. to max|ref|, renders and IRs on the same key.  FDN too: its
# Sherman-Morrison solve and grafx_tpu's LU solve agree to float32
# round-off (measured 4.3e-7 on the render).
REL = 1e-5
# rel. to max|ref| of a gradient leaf (sums over time of round-off)
GRAD_REL = 1e-4
# a streamed render against the one-shot forward (the partitioned
# convolution's spectra against one long FFT)
STREAM_REL = 1e-5

CASES = (
    [pytest.param("FilteredNoiseShapingReverb",
                  {"ir_len": 3000, "num_bands": 6, "processor_channel": ch, "use_fade_in": fade},
                  id=f"FilteredNoiseShapingReverb-{ch}-{'fade' if fade else 'nofade'}")
     for ch in ("mono", "stereo", "midside") for fade in (False, True)]
    + [pytest.param("FilteredNoiseShapingReverb",
                    {"ir_len": 3000, "num_bands": 4, "noise_randomness": "fixed"},
                    id="FilteredNoiseShapingReverb-fixed")]
    + [pytest.param("FeedbackDelayNetwork", {"ir_len": 3000, "processor_channel": ch},
                    id=f"FeedbackDelayNetwork-{ch}") for ch in ("mono", "stereo", "midside")]
    + [pytest.param("STFTMaskedNoiseReverb",
                    {"ir_len": 3000, "fixed_noise": False, "processor_channel": ch},
                    id=f"STFTMaskedNoiseReverb-{ch}")
       for ch in ("mono", "stereo", "midside", "pseudo_midside")]
)


def max_rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def both(name, kwargs):
    return getattr(jp, name)(**kwargs), getattr(tp, name)(**kwargs)


def inputs(proc, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 2, L)).astype(np.float32)
    p = {}
    for k, v in proc.parameter_size().items():
        shape = (B,) + (v if isinstance(v, tuple) else (v,))
        p[k] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return x, p


def keys(seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    return jkey, tr.key_from_numpy(np.asarray(jkey))


def takes_key(name):
    return name != "FeedbackDelayNetwork"


@pytest.mark.parametrize("name, kwargs", CASES)
def test_reverb_matches_grafx_tpu_on_the_same_key(name, kwargs):
    """The render and the IR against grafx_tpu's on one key, and a second
    key draws other noise (for the pseudo-random and per-call kinds)."""
    jproc, tproc = both(name, kwargs)
    assert jproc.parameter_size() == tproc.parameter_size()
    x, p = inputs(tproc)
    jkey, tkey = keys(5)
    kw_j = {"noise_key": jkey} if takes_key(name) else {}
    kw_t = {"noise_key": tkey} if takes_key(name) else {}
    ref = jproc(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()}, **kw_j)
    with torch.no_grad():
        got = tproc(torch.tensor(x), **{k: torch.tensor(v) for k, v in p.items()}, **kw_t)
    assert got.shape == ref.shape
    assert max_rel(got.numpy(), ref) <= REL, max_rel(got.numpy(), ref)
    ir_ref = jproc.compute_ir(*(jnp.asarray(v) for v in p.values()), **kw_j)
    with torch.no_grad():
        ir = tproc.compute_ir(*(torch.tensor(v) for v in p.values()), **kw_t)
    assert max_rel(ir.numpy(), ir_ref) <= REL, max_rel(ir.numpy(), ir_ref)
    if takes_key(name) and kwargs.get("noise_randomness") != "fixed":
        with torch.no_grad():
            other = tproc(torch.tensor(x), **{k: torch.tensor(v) for k, v in p.items()},
                          noise_key=keys(6)[1])
        assert max_rel(other.numpy(), got.numpy()) > 1e-3


@pytest.mark.parametrize("channel", ["stereo", "midside"])
def test_keyless_crops_follow_grafx_tpus_host_draws(channel):
    """Without a key each eager call crops at the next draw of the
    instance's default_rng(0), as grafx_tpu's does, call for call: three
    calls equal grafx_tpu's three, and differ from one another."""
    kwargs = {"ir_len": 2000, "num_bands": 4, "processor_channel": channel}
    jproc, tproc = both("FilteredNoiseShapingReverb", kwargs)
    x, p = inputs(tproc, seed=1)
    outs = []
    for _ in range(3):
        ref = jproc(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()})
        with torch.no_grad():
            got = tproc(torch.tensor(x), **{k: torch.tensor(v) for k, v in p.items()}).numpy()
        assert max_rel(got, ref) <= REL, max_rel(got, ref)
        outs.append(got)
    assert max_rel(outs[0], outs[1]) > 1e-3 and max_rel(outs[1], outs[2]) > 1e-3


@pytest.mark.parametrize("name, kwargs", CASES)
def test_reverb_gradients_match_jax_grad(name, kwargs):
    """d mean(y^2) / d every parameter against jax.grad on the same key."""
    jproc, tproc = both(name, kwargs)
    x, p = inputs(tproc, seed=2)
    jkey, tkey = keys(7)
    kw_j = {"noise_key": jkey} if takes_key(name) else {}
    kw_t = {"noise_key": tkey} if takes_key(name) else {}

    def loss(params):
        return jnp.mean(jproc(jnp.asarray(x), **params, **kw_j) ** 2)

    ref = jax.grad(loss)({k: jnp.asarray(v) for k, v in p.items()})
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    torch.mean(tproc(torch.tensor(x), **params, **kw_t) ** 2).backward()
    for k in p:
        got, want = params[k].grad.numpy(), np.asarray(ref[k])
        assert np.isfinite(got).all(), k
        assert max_rel(got, want) <= GRAD_REL, (k, max_rel(got, want))


@pytest.mark.parametrize("name, kwargs", CASES)
def test_reverb_streams_as_its_one_shot_forward(name, kwargs):
    """stream_init on a key, then blocks of 1024, against the one-shot
    forward on the same key."""
    _, tproc = both(name, kwargs)
    x, p = inputs(tproc, seed=3)
    kw = {"noise_key": keys(8)[1]} if takes_key(name) else {}
    tparams = {k: torch.tensor(v) for k, v in p.items()}
    with torch.no_grad():
        one_shot = tproc(torch.tensor(x), **tparams, **kw).numpy()
        state, cache = tproc.stream_init(2, BLOCK, **tparams, **kw)
        blocks = []
        for xb in torch.tensor(x).split(BLOCK, dim=-1):
            yb, state = tproc.stream_step(xb, state, cache)
            blocks.append(yb)
    got = torch.cat(blocks, dim=-1).numpy()
    assert max_rel(got, one_shot) <= STREAM_REL, max_rel(got, one_shot)


def test_fdn_solve_is_the_linear_system():
    """The Sherman-Morrison solve against torch.linalg.solve of ``(I -
    D G Q) x = D b`` in complex128, frequency by frequency."""
    proc = tp.FeedbackDelayNetwork(ir_len=600, num_delays=6)
    rng = np.random.default_rng(4)
    z = torch.tensor(rng.standard_normal((2, 6)) * 2, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((2, 6)), dtype=torch.float32)
    c = torch.eye(6)[None].expand(2, 6, 6)  # one output channel per line: H = x
    got = torch.fft.rfft(proc.compute_ir(z, b, c), n=600)
    g = 0.99 * torch.sigmoid(z.double())
    Q = torch.eye(6, dtype=torch.float64) - 2.0 / 6
    D = proc.delay_phasors.to(torch.complex128)
    A = D[None, :, :, None] * (g[:, None, :, None] * Q)
    rhs = D[None] * b.double()[:, None, :]
    want = torch.linalg.solve(torch.eye(6, dtype=torch.complex128) - A, rhs[..., None])[..., 0]
    err = (got - want.transpose(1, 2)).abs().max() / want.abs().max()
    assert err <= 1e-5, float(err)


def test_reverbs_refuse_bad_options():
    with pytest.raises(ValueError, match="channel"):
        tp.FilteredNoiseShapingReverb(ir_len=100, processor_channel="quad")
    with pytest.raises(ValueError, match="noise_randomness"):
        tp.FilteredNoiseShapingReverb(ir_len=100, noise_randomness="white")
    with pytest.raises(ValueError, match="delay lengths"):
        tp.FeedbackDelayNetwork(ir_len=100, num_delays=3, delay_lengths=[7, 11])
    for proc in (tp.FilteredNoiseShapingReverb(ir_len=100, num_bands=2),
                 tp.FeedbackDelayNetwork(ir_len=100, processor_channel="midside")):
        with pytest.raises(NotImplementedError, match="channel-diagonal"):
            proc.fir_kernel(**{k: torch.zeros((1,) + ((v,) if isinstance(v, int) else v))
                               for k, v in proc.parameter_size().items()})
