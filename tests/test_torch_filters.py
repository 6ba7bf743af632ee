"""The filters of filter.py and the zero-phase FIR equalizers of eq.py:
each class of grafx_tpu_torch against its grafx_tpu counterpart on the
same numpy inputs and parameters, on both IIR backends where it has two,
and its stream contract against its one-shot render."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu import processors as jp
from grafx_tpu_torch import processors as tp
from grafx_tpu_torch.processors.core.utils import lti_kind_of

L = 2**12
N = 3
# rel. to max|ref|: the fsm FIRs agree to float32 round-off of the sampled
# DTFT, the exact cascades of one to three sections to that of the blocks
REL = 1e-5

BIQUAD_CLASSES = [
    ("LowPassFilter", {}),
    ("HighPassFilter", {}),
    ("BandPassFilter", {}),
    ("BandRejectFilter", {}),
    ("AllPassFilter", {}),
    ("PeakingFilter", {"num_filters": 2}),
    ("LowShelf", {"num_filters": 2}),
    ("HighShelf", {"num_filters": 2}),
    ("BiquadFilter", {"num_filters": 3}),
    ("BiquadFilter", {"num_filters": 2, "normalized": True}),
    ("PoleZeroFilter", {"num_filters": 2}),
    ("StateVariableFilter", {"num_filters": 2}),
]
# the biquad equalizers' exact backend is held in test_torch_processors.py
# (to 1e-3: their low bands sit near the unit circle); here their fsm one
EQ_CLASSES = [
    ("ParametricEqualizer", {"num_filters": 6}),
    ("ParametricEqualizer", {"num_filters": 4, "processor_channel": "midside"}),
    ("GraphicEqualizer", {"scale": "bark"}),
]
FIR_CLASSES = [
    ("FIRFilter", {"fir_len": 255, "processor_channel": "mono"}),
    ("FIRFilter", {"fir_len": 255, "processor_channel": "stereo"}),
    ("FIRFilter", {"fir_len": 255, "processor_channel": "midside"}),
    ("ZeroPhaseFIREqualizer", {"num_magnitude_bins": 256}),
    ("NewZeroPhaseFIREqualizer", {"num_frequency_bins": 256}),
    ("NewZeroPhaseFIREqualizer", {"num_frequency_bins": 256, "processor_channel": "stereo"}),
    ("NewZeroPhaseFIREqualizer", {"num_frequency_bins": 256, "processor_channel": "midside"}),
    ("NewZeroPhaseFIREqualizer", {"num_frequency_bins": 256, "use_filterbank": True,
                                  "filterbank_kwargs": {"num_filters": 40}}),
]
CASES = (
    [pytest.param(name, {**kw, "backend": b}, id=f"{name}-{b}-{i}")
     for i, (name, kw) in enumerate(BIQUAD_CLASSES) for b in ("fsm", "exact")]
    + [pytest.param(name, kw, id=f"{name}-fsm-{i}") for i, (name, kw) in enumerate(EQ_CLASSES)]
    + [pytest.param(name, kw, id=f"{name}-{i}") for i, (name, kw) in enumerate(FIR_CLASSES)]
)


def max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def random_params(sizes, rows, rng, std=0.5):
    out = {}
    for k, v in sizes.items():
        shape = (rows,) + (v if isinstance(v, tuple) else (v,))
        out[k] = (std * rng.standard_normal(shape)).astype(np.float32)
    if "A0" in out:  # the normalized BiquadFilter's a0 scales its denominator
        out["A0"] = 1.0 + np.abs(out["A0"])
    return out


def both(name, kwargs):
    return getattr(jp, name)(**kwargs), getattr(tp, name)(**kwargs)


def inputs(tproc, seed=0, length=L):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 2, length)).astype(np.float32)
    return x, random_params(tproc.parameter_size(), N, rng)


@pytest.mark.parametrize("name, kwargs", CASES)
def test_filter_matches_grafx_tpu(name, kwargs):
    jproc, tproc = both(name, kwargs)
    assert jproc.parameter_size() == tproc.parameter_size()
    assert lti_kind_of(tproc) == lti_kind_of(jproc)
    x, p = inputs(tproc)
    ref = np.asarray(jax.jit(lambda x, p: jproc(x, **p))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    got = tproc(torch.tensor(x), **{k: torch.tensor(v) for k, v in p.items()}).numpy()
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= REL, max_rel(got, ref)


@pytest.mark.parametrize(
    "name, kwargs",
    [(name, {**kw, "backend": b}) for name, kw in BIQUAD_CLASSES[::3] for b in ("fsm", "exact")]
    + EQ_CLASSES[1:3]
    + [("FIRFilter", {"fir_len": 255, "processor_channel": "midside"})],
)
def test_filter_streams_like_one_shot(name, kwargs):
    """Blocks of 1024 through stream_init/stream_step, the state carried,
    reproduce the one-shot render."""
    tproc = getattr(tp, name)(**kwargs)
    x, p = inputs(tproc, seed=1)
    p = {k: torch.tensor(v) for k, v in p.items()}
    x = torch.tensor(x)
    with torch.no_grad():
        ref = tproc(x, **p)
        state, cache = tproc.stream_init(2, 1024, **p)
        blocks = []
        for xb in x.split(1024, dim=-1):
            yb, state = tproc.stream_step(xb, state, cache)
            blocks.append(yb)
    got = torch.cat(blocks, dim=-1).numpy()
    assert max_rel(got, ref.numpy()) <= REL


@pytest.mark.parametrize("cls", ["ParametricEqualizer", "GraphicEqualizer", "LowPassFilter"])
def test_defaults_are_fsm(cls):
    """The default backend is the reference's, fsm, in both packages; it
    makes the cascade an FIR-LTI processor."""
    proc = getattr(tp, cls)()
    assert proc.biquad.backend == getattr(jp, cls)().biquad.backend == "fsm"
    assert lti_kind_of(proc) == "fir"


def test_zero_phase_fir_kernel_and_refusals():
    """The zero-phase EQs' fir_kernel has shift L_h // 2 and equals
    grafx_tpu's; midside is not fusable and raises, as in grafx_tpu; a
    zero-phase EQ refuses to stream (it needs lookahead)."""
    jproc, tproc = both("NewZeroPhaseFIREqualizer", {"num_frequency_bins": 128})
    _, p = inputs(tproc)
    h_j, s_j, _ = jproc.fir_kernel(**{k: jnp.asarray(v) for k, v in p.items()})
    h, s, aux = tproc.fir_kernel(**{k: torch.tensor(v) for k, v in p.items()})
    assert s == s_j == h.shape[-1] // 2 and aux is None
    assert max_rel(h.numpy(), np.asarray(h_j)) <= REL
    ms = tp.NewZeroPhaseFIREqualizer(num_frequency_bins=128, processor_channel="midside")
    with pytest.raises(NotImplementedError, match="midside"):
        ms.fir_kernel(log_magnitude=torch.zeros(1, 2, 128))
    with pytest.raises(NotImplementedError, match="zero-phase"):
        tproc.stream_init(2, 1024, **{k: torch.tensor(v) for k, v in p.items()})


def test_geq_fsm_matches_eager_grafx_tpu():
    """The GEQ on fsm, on the third-octave and the bark scale: within REL
    of grafx_tpu's op-by-op (eager) result, and against its jitted one
    within the reference's own jit-vs-eager spread + REL.  XLA's fused
    program differs from grafx_tpu's own eager ops by 2.0e-5 of max|ref|
    on the third-octave scale (1.1e-5 on bark): its band design's exp and
    sqrt round differently near z = 1, where the 19.7 Hz band's poles
    amplify that; the port is within 3.2e-6 of the eager result."""
    for scale in ("third_octave", "bark"):
        kwargs = {"scale": scale, "processor_channel": "stereo"}
        jproc, tproc = both("GraphicEqualizer", kwargs)
        x, p = inputs(tproc)
        args = (jnp.asarray(x), jnp.asarray(p["log_gains"]))
        eager = np.asarray(jproc(*args))
        jitted = np.asarray(jax.jit(lambda x, g: jproc(x, g))(*args))
        got = tproc(torch.tensor(x), torch.tensor(p["log_gains"])).numpy()
        assert max_rel(got, eager) <= REL, (scale, max_rel(got, eager))
        spread = max_rel(jitted, eager)
        assert max_rel(got, jitted) <= spread + REL, (scale, max_rel(got, jitted), spread)
