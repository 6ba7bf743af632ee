"""The plain versions of the gain kernels (#1-#6), of the plain
smoother's forward with residuals and adjoint (#8, #9) and of the
reverse scan (#10) against the Pallas kernels they replace, run as
tests/ops/test_ballistics_pallas.py runs them (time-major padded layout,
small chunk, interpret mode), and the autograd Functions around the
training kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grafx_tpu.ops.ballistics import ballistics_core as j_ballistics_core
from grafx_tpu.ops.ballistics_tpu import (
    LANES,
    backward_fused_pallas_tm,
    backward_gain_pair_pallas_tm,
    backward_gain_pallas_tm,
    expand_lanes,
    forward_gain_only_pallas_tm,
    forward_gain_pair_pallas_tm,
    forward_gain_pallas_tm,
    forward_pallas_tm_d,
    pad_time_major,
    reverse_scan_pallas_tm,
)
from grafx_tpu_torch.ops import _cuda
from grafx_tpu_torch.ops import ballistics as bal
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
        # odd N and L % 4 = 1, 2, 3: row starts off 16-byte alignment on the card
        ("compressor", 9, 201, False, False),
        ("noisegate", 9, 202, True, False),
        ("noisegate", 37, 203, False, False),
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
        (("noisegate", "compressor"), (0.0, 1.0), 9, 201, None),  # odd N, L % 4 = 1
        (("compressor", "noisegate"), (1.0, 1.0), 37, 203, None),  # L % 4 = 3
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


# ---------------------------------------------------------------------------
# Training kernels (#3-#6): forwards with residuals and adjoints
# ---------------------------------------------------------------------------

RTOL_GAIN, ATOL_GAIN = 2e-4, 2e-5  # tests/ops/test_ballistics_pallas.py:210-211
RTOL_PAIR, ATOL_PAIR = 3e-4, 3e-5  # tests/ops/test_ballistics_pallas.py:333-334


def _pick(v, N):
    return np.asarray(v[::8].reshape(-1)[:N])


def _close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)


GAIN_BWD_CASES = [
    ("compressor", 5, 192, False, False),
    ("noisegate", 5, 200, False, False),  # 200: the end pad crosses the carry
    ("compressor", 130, 96, False, False),  # ragged N across lane groups
    ("noisegate", 3, 200, True, False),  # one-pole, initial state 0
    ("compressor", 4, 192, False, True),
    ("compressor", 9, 201, False, False),  # odd N, L % 4 = 1
    ("noisegate", 37, 203, True, False),  # L % 4 = 3
]
PAIR_BWD_CASES = [
    (("noisegate", "compressor"), (1.0, 1.0), 5, 192, None),
    (("noisegate", "compressor"), (0.0, 1.0), 5, 200, None),  # one-pole gate
    (("compressor", "noisegate"), (1.0, 1.0), 130, 96, None),  # ragged N
    (("noisegate", "compressor"), (0.0, 1.0), 6, 200, 0),  # padded gate
    (("noisegate", "compressor"), (1.0, 1.0), 3, 160, 1),
    (("noisegate", "compressor"), (0.0, 1.0), 9, 202, None),  # odd N, L % 4 = 2
    (("compressor", "noisegate"), (1.0, 1.0), 37, 203, 0),  # L % 4 = 3, absent first member
]


@pytest.mark.parametrize("kind, N, L, onepole, absent", GAIN_BWD_CASES)
def test_gain_fwd_bwd_plain_match_pallas(kind, N, L, onepole, absent):
    """#5 and #6: gain, residuals and every gradient against
    forward_gain_pallas_tm / backward_gain_pallas_tm."""
    rng = np.random.RandomState(N + L + 3)
    u = _energy(rng, N, L)
    consts = _consts(rng, N, kind, onepole, absent)
    gg = rng.randn(N, L).astype(np.float32)
    ut = pad_time_major(jnp.asarray(u), CHUNK)
    lanes = [_lanes(c) for c in consts]
    gain_t, d_t, ylast = forward_gain_pallas_tm(ut, *lanes, chunk=CHUNK, kind=kind, interpret=True)
    outs = backward_gain_pallas_tm(
        d_t, ut, ylast, pad_time_major(jnp.asarray(gg), CHUNK), *lanes[1:],
        chunk=CHUNK, kind=kind, interpret=True,
    )

    before = bal.launch_counts()
    gain, d, y_last = bal.ballistics_gain_fwd(torch.tensor(u), *_t(consts), kind=kind)
    _close(gain, gain_t[:L, :N].T, RTOL_GAIN, ATOL_GAIN, "gain")
    _close(d, d_t[:L, :N].T, RTOL_GAIN, ATOL_GAIN, "d")
    np.testing.assert_array_equal(
        gain.numpy(), bal.ballistics_gain_plain(torch.tensor(u), *_t(consts), kind=kind).numpy()
    )
    # y_last is the walk's state at L - 1
    walk = bal._walk(torch.tensor(u), *_t(consts[:3]))
    np.testing.assert_array_equal(y_last.numpy(), walk[:, -1].numpy())
    if L % CHUNK == 0:  # with end padding the TPU's saved state walks through the pad
        _close(y_last, _pick(ylast, N), RTOL_GAIN, ATOL_GAIN, "y_last")
    got = bal.ballistics_gain_bwd(
        torch.tensor(u), d, y_last, torch.tensor(gg), *_t(consts[1:]), kind=kind
    )
    assert bal.launch_counts() == before  # CPU tensors: plain versions
    names = ["du", "dzi", "dat", "drt", "dth", "dcf", "dhk"]
    refs = [outs[0][:L, :N].T, outs[3], outs[1], outs[2], outs[4], outs[5], outs[6]]
    for name, g, ref in zip(names, got, refs):
        assert g.shape == ((N, L) if name == "du" else (N,))
        _close(g, ref if name == "du" else _pick(ref, N), RTOL_GAIN, ATOL_GAIN, f"{kind} {name}")
    if absent:  # cf = 0: gain 1, and no gradient reaches the walk or the knee
        assert np.all(gain.numpy() == 1.0)
        for name, g in zip(names, got):
            if name != "dcf":  # the cotangent of cf itself, which the mask zeroes
                assert np.all(g.numpy() == 0.0), name


@pytest.mark.parametrize("kinds, inits, N, L, absent", PAIR_BWD_CASES)
def test_gain_pair_fwd_bwd_plain_match_pallas(kinds, inits, N, L, absent):
    """#3 and #4: gain, residuals and the eleven gradients against
    forward_gain_pair_pallas_tm(with_residuals=True) /
    backward_gain_pair_pallas_tm."""
    rng = np.random.RandomState(N + L + 11)
    u = _energy(rng, N, L)
    ca = _consts(rng, N, kinds[0], onepole=inits[0] == 0.0, absent=absent == 0)[1:]
    cb = _consts(rng, N, kinds[1], absent=absent == 1)[1:]
    gg = rng.randn(N, L).astype(np.float32)
    ut = pad_time_major(jnp.asarray(u), CHUNK)
    la, lb = tuple(_lanes(c) for c in ca), tuple(_lanes(c) for c in cb)
    gain_t, da_t, db_t, vlast, ulast = forward_gain_pair_pallas_tm(
        ut, la, lb, chunk=CHUNK, kinds=kinds, interpret=True, with_residuals=True, inits=inits,
    )
    outs = backward_gain_pair_pallas_tm(
        da_t, db_t, ut, vlast, ulast, pad_time_major(jnp.asarray(gg), CHUNK), la, lb,
        chunk=CHUNK, kinds=kinds, interpret=True,
    )

    before = bal.launch_counts()
    ut_ = torch.tensor(u)
    gain, d_a, d_b, v_last, u_last = bal.ballistics_gain_pair_fwd(
        ut_, *_t(ca), *_t(cb), kinds=kinds, inits=inits
    )
    _close(gain, gain_t[:L, :N].T, RTOL_PAIR, ATOL_PAIR, "gain")
    _close(d_a, da_t[:L, :N].T, RTOL_PAIR, ATOL_PAIR, "d_a")
    _close(d_b, db_t[:L, :N].T, RTOL_PAIR, ATOL_PAIR, "d_b")
    np.testing.assert_array_equal(
        gain.numpy(),
        bal.ballistics_gain_pair_plain(ut_, *_t(ca), *_t(cb), kinds=kinds, inits=inits).numpy(),
    )
    if L % CHUNK == 0:  # with end padding the TPU's saved states walk through the pad
        _close(v_last, _pick(vlast, N), RTOL_PAIR, ATOL_PAIR, "v_last")
        _close(u_last, _pick(ulast, N), RTOL_PAIR, ATOL_PAIR, "u_last")
    got = bal.ballistics_gain_pair_bwd(
        ut_, d_a, d_b, v_last, u_last, torch.tensor(gg), *_t(ca), *_t(cb), kinds=kinds
    )
    assert bal.launch_counts() == before
    names = ["du", "dat_a", "drt_a", "dth_a", "dcf_a", "dhk_a",
             "dat_b", "drt_b", "dth_b", "dcf_b", "dhk_b"]
    for i, (name, g) in enumerate(zip(names, got)):
        ref = outs[0][:L, :N].T if i == 0 else _pick(outs[i], N)
        _close(g, ref, RTOL_PAIR, ATOL_PAIR, name)
    if absent is not None:
        member = "_a" if absent == 0 else "_b"
        for name, g in zip(names, got):
            if name.endswith(member) and not name.startswith("dcf"):
                assert np.all(g.numpy() == 0.0), name


# ---------------------------------------------------------------------------
# The chunked reverse walk of the CUDA adjoints (#4, #6, #9), mirrored in
# PyTorch: _reverse_walk_chunked against the serial _reverse_walk, and the
# plain adjoints with it substituted against the Pallas kernels
# ---------------------------------------------------------------------------


def _chunk(spec, L):
    """A chunk length: a number, ``"L"`` (the row's tiles: one chunk) or
    ``">L"`` (longer than the row)."""
    whole = -(-L // 32) * 32
    return {"L": whole, ">L": whole + 96}.get(spec, spec)


def _walk_inputs(N, L, chunk, seed):
    """(g, d, at, rt): random rows, every third row's decisions switching
    exactly at each chunk boundary (attack on even chunks, release on odd
    ones), every fourth row absent (g = 0); release factors down to 0.005
    so that gh carries across many chunks."""
    rng = np.random.RandomState(seed)
    g = rng.randn(N, L)
    d = rng.randn(N, L)
    switch = np.where((np.arange(L) // chunk) % 2 == 0, 1.0, -1.0) * (0.1 + np.abs(d))
    d[1::3] = switch[1::3]
    g[3::4] = 0.0
    at = rng.uniform(0.05, 0.9, N)
    rt = rng.uniform(0.005, 0.3, N)
    return [torch.tensor(np.asarray(v, np.float32)) for v in (g, d, at, rt)]


@pytest.mark.parametrize("N", [1, 8, 68])
@pytest.mark.parametrize("L", [64, 200, 4096, 4109])
@pytest.mark.parametrize("spec", [32, 64, 256, "L", ">L"])
def test_reverse_walk_chunked_matches_serial(spec, L, N):
    """The three-pass decomposition against the serial walk: du within
    1e-6 of max|ref|, dzi / dat / drt within 1e-5 of theirs, absent rows
    exactly 0, and one chunk bit for bit.  Where a per-row sum cancels so
    far that the serial float32 walk itself is farther than that from the
    float64 walk, the chunked walk is held to twice the serial walk's own
    error against float64."""
    chunk = _chunk(spec, L)
    g, d, at, rt = _walk_inputs(N, L, chunk, seed=N + L)
    ref = bal._reverse_walk(g, d, at, rt)
    ref64 = bal._reverse_walk(g.double(), d, at.double(), rt.double())
    got = bal._reverse_walk_chunked(g, d, at, rt, chunk)
    for name, v, r, r64, rel in zip(
        ("du", "dat", "drt", "dzi"), got, ref, ref64, (1e-6, 1e-5, 1e-5, 1e-5)
    ):
        assert v.shape == r.shape, name
        err64 = (v.double() - r64).abs().max()
        assert (v - r).abs().max() <= rel * r.abs().max() or (
            name != "du" and err64 <= 2 * (r.double() - r64).abs().max()
        ), name
        assert bool((v[3::4] == 0).all()), f"absent rows: {name}"
    if chunk >= L:
        for name, v, r in zip(("du", "dat", "drt", "dzi"), got, ref):
            assert torch.equal(v, r), name


@pytest.mark.parametrize("N", [1, 8, 68])
@pytest.mark.parametrize("L", [64, 200, 4096, 4109])
@pytest.mark.parametrize("spec", [32, 64, 256, "L", ">L"])
def test_reverse_scan_chunked_matches_serial(spec, L, N):
    """#10's decomposition (the chunked walk with the coefficient read)
    against the serial scan: gh within 1e-6 of max|ref| (the adjoint
    walk's du bound), rows of zeros exactly 0, and one chunk bit for bit.
    Coefficients up to 0.999, so that gh carries across many chunks."""
    chunk = _chunk(spec, L)
    rng = np.random.RandomState(N + L + 1)
    a = rng.uniform(0.05, 0.999, (N, L))
    g = rng.randn(N, L)
    g[3::4] = 0.0
    a, g = (torch.tensor(np.asarray(v, np.float32)) for v in (a, g))
    ref = bal.reverse_scan_plain(a, g)
    got = bal._reverse_scan_chunked(a, g, chunk)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    assert bool((got[3::4] == 0).all())
    if chunk >= L:
        assert torch.equal(got, ref)


def test_walk_chunk_picks_and_checks_the_chunk_length():
    """The console's shapes on an H100's resident virtual rows (68 pair
    rows and 8 bus rows of 2^17, the factorized compressor's 68 x 128
    frame calls), no slots, clamping, and refusals on every device."""
    h100 = 132 * 8 * 32  # 132 SMs x 8 one-warp blocks x 32 lanes
    assert bal.walk_chunk(68, 2**17, slots=h100) == 288  # 456 chunks: 969 warps
    assert bal.walk_chunk(8, 2**17, slots=h100) == 64  # 2048 chunks: 512 warps
    assert bal.walk_chunk(68, 128, slots=h100) == 128  # one chunk: the whole-row walk
    assert bal.walk_chunk(68, 200, slots=h100) == 64
    assert bal.walk_chunk(68, 2**17, slots=h100 // 2) == 544  # half the slots: 248 chunks a row
    assert bal.walk_chunk(68, 2**17) == 2**17  # no slots: the whole row
    assert bal.walk_chunk(3, 4109) == 4128
    assert bal.walk_chunk(3, 4109, 8192) == 4128
    assert bal.walk_chunk(3, 4109, 32) == 32
    u = torch.zeros(2, 64)
    c = torch.full((2,), 0.5)
    for bad in (0, 48, -32, 32.0, True):
        with pytest.raises(ValueError, match="multiple of 32"):
            bal.walk_chunk(2, 64, bad)
        with pytest.raises(ValueError, match="multiple of 32"):
            bal.ballistics_bwd(u, u, c, c, chunk=bad)
        with pytest.raises(ValueError, match="multiple of 32"):
            bal.ballistics_gain_bwd(u, u, c, u, *[c] * 5, chunk=bad)
        with pytest.raises(ValueError, match="multiple of 32"):
            bal.ballistics_gain_pair_bwd(u, u, u, c, c, u, *[c] * 10, chunk=bad)


def test_walk_samples_picks_and_checks_the_stage_length():
    """The forward walks' stage: the console's shapes (rows of 2^17 and
    the stream's 4096: 1024; the factorized compressor's 128 frames: one
    stage of the row), ragged rows rounded up to 32, forced lengths, and
    refusals on every device."""
    assert bal.walk_samples(2**17) == 1024
    assert bal.walk_samples(4096) == 1024
    assert bal.walk_samples(2**17 + 13) == 1024
    assert bal.walk_samples(128) == 128  # one stage: the row's length
    assert bal.walk_samples(201) == 224
    assert bal.walk_samples(1) == 32
    assert bal.walk_samples(4109, 256) == 256
    assert bal.walk_samples(40, samples=1024) == 1024
    for bad in (0, 48, -32, 2048, 32.0, True, "64"):
        with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
            bal.walk_samples(64, samples=bad)
    u = torch.zeros(2, 64)
    c = torch.zeros(2)
    for call in (lambda: bal._gain_fwd_cuda("t", u, [c] * 6, "compressor", True, 48),
                 lambda: bal._pair_fwd_cuda("t", u, [c] * 10, ("noisegate", "compressor"),
                                            (1.0, 1.0), False, 2048),
                 lambda: bal._walk_fwd_cuda("t", u, [c] * 3, True, 0)):
        with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
            call()


def _substitute_chunked_walk(monkeypatch, chunk):
    monkeypatch.setattr(
        bal, "_reverse_walk", lambda g, d, at, rt: bal._reverse_walk_chunked(g, d, at, rt, chunk)
    )


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("kind, N, L, onepole, absent", GAIN_BWD_CASES)
def test_gain_bwd_chunked_walk_matches_pallas(monkeypatch, chunk, kind, N, L, onepole, absent):
    """#6 as the card computes it: ballistics_gain_bwd_plain with the
    chunked walk against backward_gain_pallas_tm."""
    _substitute_chunked_walk(monkeypatch, chunk)
    test_gain_fwd_bwd_plain_match_pallas(kind, N, L, onepole, absent)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("kinds, inits, N, L, absent", PAIR_BWD_CASES)
def test_gain_pair_bwd_chunked_walk_matches_pallas(monkeypatch, chunk, kinds, inits, N, L, absent):
    """#4 as the card computes it: ballistics_gain_pair_bwd_plain with the
    chunked walk (both members) against backward_gain_pair_pallas_tm."""
    _substitute_chunked_walk(monkeypatch, chunk)
    test_gain_pair_fwd_bwd_plain_match_pallas(kinds, inits, N, L, absent)


def _leaves(n, seed):
    rng = np.random.RandomState(seed)
    u = _energy(rng, n, 70)
    ca = _consts(rng, n, "noisegate", onepole=True)[1:]
    cb = _consts(rng, n, "compressor")[1:]
    return [torch.tensor(a, requires_grad=True) for a in (u, *ca, *cb)], rng.randn(n, 70)


@pytest.mark.parametrize("pair", [False, True])
def test_autograd_functions_match_autograd_through_the_plain_walk(pair):
    """The cores under autograd (the Functions around #3-#6) against torch
    autograd through the plain primal, which differentiates the walk's
    in-place loop; the decisions are held constant in both."""
    leaves, gg = _leaves(4, 5 + pair)
    u, consts = leaves[0], leaves[1:]
    zi = torch.rand(4, dtype=torch.float32, requires_grad=True)
    if pair:
        def run(core):
            return core(u, *consts, kinds=("noisegate", "compressor"), inits=(0.0, 1.0))
        cores = (ballistics_gain_pair_core, bal.ballistics_gain_pair_plain)
        inputs = leaves
    else:
        def run(core):
            return core(u, zi, *consts[5:], kind="compressor")
        cores = (ballistics_gain_core, bal.ballistics_gain_plain)
        inputs = [u, zi, *consts[5:]]
    gg = torch.tensor(gg, dtype=torch.float32)
    before = bal.launch_counts()
    got_out = run(cores[0])
    got = torch.autograd.grad((got_out * gg).sum(), inputs)
    ref_out = run(cores[1])
    ref = torch.autograd.grad((ref_out * gg).sum(), inputs)
    assert bal.launch_counts() == before
    np.testing.assert_array_equal(got_out.detach().numpy(), ref_out.detach().numpy())
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL_PAIR, atol=ATOL_PAIR, err_msg=str(i))


def test_training_wrappers_refuse_other_devices():
    u = torch.empty(2, 8, device="meta")
    c = torch.empty(2, device="meta")
    calls = [
        lambda: bal.ballistics_gain_fwd(u, *[c] * 6),
        lambda: bal.ballistics_gain_bwd(u, u, c, u, *[c] * 5),
        lambda: bal.ballistics_gain_pair_fwd(u, *[c] * 10),
        lambda: bal.ballistics_gain_pair_bwd(u, u, u, c, c, u, *[c] * 10),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# ---------------------------------------------------------------------------
# The plain smoother under gradient (#8, #9) and the reverse scan (#10)
# ---------------------------------------------------------------------------

# tests/ops/test_ballistics_pallas.py:52, and odd N with L % 4 = 1
WALK_SHAPES = [(3, 200), (5, 64), (130, 96), (9, 201)]
RTOL_Y, ATOL_Y = 1e-5, 1e-6  # y: tests/ops/test_ballistics_pallas.py:57-58
RTOL_D, ATOL_D = 1e-4, 1e-5  # d, du, dzi: :63, :97, :105
RTOL_C, ATOL_C = 1e-3, 1e-4  # dat, drt: :99-103


def _walk_setup(N, L, seed):
    """(u, zi, at, rt) as tests/ops/test_ballistics_pallas.py:_setup draws
    them."""
    rng = np.random.RandomState(seed)
    u = np.abs(rng.randn(N, L)).astype(np.float32)
    zi = np.abs(rng.randn(N)).astype(np.float32)
    at = rng.uniform(0.05, 0.9, N).astype(np.float32)
    rt = rng.uniform(0.01, 0.3, N).astype(np.float32)
    return u, zi, at, rt


def _walk_pallas(u, zi, at, rt):
    """``(y_t, d_t)`` of ``forward_pallas_tm_d`` in its padded layout."""
    return forward_pallas_tm_d(
        pad_time_major(jnp.asarray(u), CHUNK), _lanes(zi), _lanes(at), _lanes(rt),
        chunk=CHUNK, interpret=True,
    )


@pytest.mark.parametrize("N, L", WALK_SHAPES)
def test_ballistics_fwd_plain_matches_pallas(N, L):
    """#8: the walk and its residual ``d = u - y[n-1]`` against
    forward_pallas_tm_d; ``y`` is the primal walk's, bit for bit."""
    args = _walk_setup(N, L, N)
    yt, dt = _walk_pallas(*args)
    before = bal.launch_counts()
    y, d = bal.ballistics_fwd(*_t(args))
    assert bal.launch_counts() == before  # CPU tensors: plain version
    _close(y, yt[:L, :N].T, RTOL_Y, ATOL_Y, "y")
    _close(d, dt[:L, :N].T, RTOL_D, ATOL_D, "d")
    np.testing.assert_array_equal(y.numpy(), bal.ballistics_plain(*_t(args)).numpy())


@pytest.mark.parametrize("N, L", WALK_SHAPES)
def test_ballistics_bwd_plain_matches_pallas(N, L):
    """#9: ``du``, ``dzi``, ``dat`` and ``drt`` against
    backward_fused_pallas_tm from the same residual and cotangent."""
    u, zi, at, rt = _walk_setup(N, L, N + 7)
    g = np.random.RandomState(N + 11).randn(N, L).astype(np.float32)
    _, dt = _walk_pallas(u, zi, at, rt)
    du_t, dat, drt, dzi = backward_fused_pallas_tm(
        dt, pad_time_major(jnp.asarray(g), CHUNK), _lanes(at), _lanes(rt),
        chunk=CHUNK, interpret=True,
    )
    d = np.asarray(dt[:L, :N].T)
    before = bal.launch_counts()
    got = bal.ballistics_bwd(*_t([d, g, at, rt]))
    assert bal.launch_counts() == before
    assert got[0].shape == (N, L) and all(v.shape == (N,) for v in got[1:])
    _close(got[0], du_t[:L, :N].T, RTOL_D, ATOL_D, "du")
    _close(got[1], _pick(dzi, N), RTOL_D, ATOL_D, "dzi")
    _close(got[2], _pick(dat, N), RTOL_C, ATOL_C, "dat")
    _close(got[3], _pick(drt, N), RTOL_C, ATOL_C, "drt")


@pytest.mark.parametrize("N, L", WALK_SHAPES)
def test_reverse_scan_plain_matches_pallas(N, L):
    """#10: ``gh[n] = g[n] + a[n] gh[n+1]`` against reverse_scan_pallas_tm
    (the time pad at the end zeroed in ``a`` and ``g``, as
    reverse_scan_pallas pads); the bound of the adjoint walk's ``du``."""
    rng = np.random.RandomState(N + L)
    a = rng.uniform(0.1, 0.99, (N, L)).astype(np.float32)
    g = rng.randn(N, L).astype(np.float32)
    ref = reverse_scan_pallas_tm(
        pad_time_major(jnp.asarray(a), CHUNK), pad_time_major(jnp.asarray(g), CHUNK),
        chunk=CHUNK, interpret=True,
    )
    before = bal.reverse_scan.launches
    got = bal.reverse_scan(*_t([a, g]))
    assert bal.reverse_scan.launches == before
    assert got.shape == (N, L)
    _close(got, ref[:L, :N].T, RTOL_D, ATOL_D, "gh")
    # the coefficient at n, not at n + 1: gh[L-1] = g[L-1] and
    # gh[L-2] = g[L-2] + a[L-2] g[L-1]
    np.testing.assert_array_equal(got[:, -1].numpy(), g[:, -1])
    np.testing.assert_allclose(
        got[:, -2].numpy(), g[:, -2] + a[:, -2] * g[:, -1], rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize("N, L", [(3, 200), (5, 64)])
def test_ballistics_core_gradient_matches_jax_and_autograd(N, L):
    """ballistics_core under autograd (the Function around #8/#9) against
    jax.vjp of grafx_tpu's ballistics_core and against torch autograd
    through the plain walk, in u, zi, at and rt."""
    args = _walk_setup(N, L, N + 3)
    g = np.random.RandomState(N + 5).randn(N, L).astype(np.float32)
    y_j, vjp = jax.vjp(j_ballistics_core, *(jnp.asarray(a) for a in args))
    ref_j = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    before = bal.launch_counts()
    y = bal.ballistics_core(*leaves)
    got = torch.autograd.grad((y * torch.tensor(g)).sum(), leaves)
    assert bal.launch_counts() == before
    _close(y.detach(), y_j, RTOL_Y, ATOL_Y, "y")
    for name, v, r, (rtol, atol) in zip(
        ("du", "dzi", "dat", "drt"), got, ref_j,
        [(RTOL_D, ATOL_D)] * 2 + [(RTOL_C, ATOL_C)] * 2,
    ):
        _close(v, r, rtol, atol, name)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y_plain = bal.ballistics_plain(*leaves)
    ref = torch.autograd.grad((y_plain * torch.tensor(g)).sum(), leaves)
    np.testing.assert_array_equal(y.detach().numpy(), y_plain.detach().numpy())
    for i, (v, r) in enumerate(zip(got, ref)):
        _close(v, r, RTOL_PAIR, ATOL_PAIR, str(i))


def test_smoother_wrappers_refuse_other_devices():
    u = torch.empty(2, 8, device="meta")
    c = torch.empty(2, device="meta")
    calls = [
        lambda: bal.ballistics_fwd(u, c, c, c),
        lambda: bal.ballistics_bwd(u, u, c, c),
        lambda: bal.reverse_scan(u, u),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
