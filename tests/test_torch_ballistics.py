"""The plain versions of the two forward gain kernels against the Pallas
kernels they replace, run as tests/ops/test_ballistics_pallas.py runs
them (time-major padded layout, small chunk, interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu.ops.ballistics_tpu import (
    LANES,
    expand_lanes,
    forward_gain_only_pallas_tm,
    forward_gain_pair_pallas_tm,
    pad_time_major,
)
from grafx_tpu_torch.ops import _cuda
from grafx_tpu_torch.ops.ballistics import (
    ballistics_gain_core,
    ballistics_gain_pair_core,
)

CHUNK = 64  # small chunk so tiny shapes still cross chunk boundaries
# the bound benchmarks/verify_ballistics_tpu.py holds the TPU kernels to
MAX_ABS = 2e-5


def _consts(rng, N, kind, onepole=False, absent=False):
    """(zi, at, rt, th, cf, hk) as float32 arrays (the ranges of
    tests/ops/test_ballistics_pallas.py)."""
    at = rng.uniform(0.05, 0.9, N)
    rt = rng.uniform(0.01, 0.3, N)
    zi = np.abs(rng.randn(N))
    if onepole:  # exact one-pole: at == rt == 1 - alpha, initial state 0
        at = rt = rng.uniform(0.02, 0.5, N)
        zi = np.zeros(N)
    th = rng.uniform(-3.0, 1.0, N)
    if kind == "compressor":
        cf = rng.uniform(-0.9, -0.2, N)
    else:
        cf = rng.uniform(0.5, 3.0, N)
    if absent:
        cf = np.zeros(N)
    hk = rng.uniform(0.1, 1.0, N)
    return [np.asarray(v, np.float32) for v in (zi, at, rt, th, cf, hk)]


def _energy(rng, N, L):
    return np.abs(rng.randn(N, L)).astype(np.float32)


def _lanes(v):
    return expand_lanes(jnp.asarray(v), -(-v.shape[0] // LANES))


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize(
    "kind, N, L, onepole, absent",
    [
        ("compressor", 5, 192, False, False),
        ("noisegate", 5, 200, False, False),
        ("compressor", 130, 96, False, False),  # ragged N across lane groups
        ("noisegate", 3, 160, True, False),
        ("compressor", 4, 128, False, True),
    ],
)
def test_gain_plain_matches_pallas(kind, N, L, onepole, absent):
    rng = np.random.RandomState(N + L)
    u = _energy(rng, N, L)
    consts = _consts(rng, N, kind, onepole, absent)
    ref = forward_gain_only_pallas_tm(
        pad_time_major(jnp.asarray(u), CHUNK), *[_lanes(c) for c in consts],
        chunk=CHUNK, kind=kind, interpret=True,
    )
    ref = np.asarray(ref[:L, :N].T)
    before = ballistics_gain_core.launches
    got = ballistics_gain_core(torch.tensor(u), *_t(consts), kind=kind).numpy()
    assert ballistics_gain_core.launches == before  # CPU tensors: plain version
    assert got.shape == (N, L)
    assert np.abs(got - ref).max() < MAX_ABS
    if absent:
        assert np.all(got == 1.0)


@pytest.mark.parametrize(
    "kinds, inits, N, L, absent",
    [
        (("noisegate", "compressor"), (1.0, 1.0), 5, 192, None),
        (("noisegate", "compressor"), (0.0, 1.0), 5, 200, None),  # one-pole gate
        (("compressor", "noisegate"), (1.0, 1.0), 130, 96, None),  # ragged N
        (("noisegate", "compressor"), (0.0, 1.0), 6, 128, 0),  # padded gate
        (("noisegate", "compressor"), (1.0, 1.0), 3, 160, 1),
    ],
)
def test_gain_pair_plain_matches_pallas(kinds, inits, N, L, absent):
    rng = np.random.RandomState(N + L + 7)
    u = _energy(rng, N, L)
    ca = _consts(rng, N, kinds[0], onepole=inits[0] == 0.0, absent=absent == 0)[1:]
    cb = _consts(rng, N, kinds[1], absent=absent == 1)[1:]
    ref = forward_gain_pair_pallas_tm(
        pad_time_major(jnp.asarray(u), CHUNK),
        tuple(_lanes(c) for c in ca), tuple(_lanes(c) for c in cb),
        chunk=CHUNK, kinds=kinds, interpret=True, with_residuals=False, inits=inits,
    )
    ref = np.asarray(ref[:L, :N].T)
    before = ballistics_gain_pair_core.launches
    got = ballistics_gain_pair_core(
        torch.tensor(u), *_t(ca), *_t(cb), kinds=kinds, inits=inits
    ).numpy()
    assert ballistics_gain_pair_core.launches == before
    assert got.shape == (N, L)
    assert np.abs(got - ref).max() < MAX_ABS
    if absent is not None:
        # an absent member's gain is exactly 1: the pair is the other
        # member's single gain, bit for bit
        present, init, c = (1, inits[1], cb) if absent == 0 else (0, inits[0], ca)
        zi = np.full(N, init, np.float32)
        alone = ballistics_gain_core(
            torch.tensor(u), *_t([zi, *c]), kind=kinds[present]
        ).numpy()
        if absent == 0:
            np.testing.assert_array_equal(got, alone)
        else:
            assert np.abs(got - alone).max() < MAX_ABS


def test_wrappers_refuse_other_devices():
    u = torch.empty(2, 8, device="meta")
    c = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ballistics_gain_core(u, c, c, c, c, c, c)
    with pytest.raises(ValueError, match="unsupported device"):
        ballistics_gain_pair_core(u, *[c] * 10)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()
