"""The frame gain op (``ops/ballistics.py:frame_gain_core``,
``csrc/frame_gain.cu``) on the card: its forward and adjoint kernels
against their plain versions on the same card at the factorized
console's shapes (68 and 8 rows x 2^17, frames of 1024) and a ragged one,
and a captured CUDA graph of a forward and backward against the eager
call.  The CPU runs the plain versions, which
``tests/test_torch_factorized.py`` holds to the composite they replace.
On the card: ``python -m pytest --noconftest -m card
tests/test_torch_frame_gain.py -q``."""

import pytest
import torch

from grafx_tpu_torch.ops import ballistics as bal

# (rows, samples, frame_len): the chains' and the buses' compressors of
# the factorized console, and a ragged row in frames of 256 (its last one
# short, its length no multiple of 4: the scalar path)
SHAPES = {"A": (68, 2**17, 1024), "B": (8, 2**17, 1024), "ragged": (37, 3 * 1024 + 5, 256)}
MAX_ABS = 2e-5  # of max(1, max |ref|) for each output


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


def frame_case(device, n, length, seed=0):
    """Energy with -40 dB passages, per-row constants around its level
    (thresholds below, near and above it), and a gain cotangent scaled so
    that the per-row sums are of order one."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

    quiet = torch.where(uniform(0, 1, n, length) < 0.3, 1e-4, 1.0)
    u = torch.randn(n, length, generator=g, device=device) ** 2 * quiet
    at, rt = torch.sigmoid(uniform(-4.0, 2.0, 2, n))
    th = torch.log(u.mean(-1)) + uniform(-3.0, 3.0, n)
    cf = 1.0 / (1.0 + torch.exp(uniform(-1.0, 1.0, n))) - 1.0
    hk = torch.exp(uniform(0.5, 1.5, n)) / 2.0
    gg = torch.randn(n, length, generator=g, device=device) / length**0.5
    return u, (at, rt, th, cf, hk), gg


def assert_close(got, ref, label):
    err = (got - ref).abs().max().item()
    assert err <= MAX_ABS * max(1.0, ref.abs().max().item()), (label, err)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernels_match_their_plain_versions(card, shape):
    n, length, frame_len = SHAPES[shape]
    u, consts, gg = frame_case(card, n, length)
    bal.reset_launch_counts()
    gain, s, d = bal.frame_gain_fwd(u, *consts, frame_len)
    primal = bal.frame_gain_core(u, *consts, frame_len)
    got = bal.frame_gain_bwd(s, d, gg, *consts, frame_len)
    torch.cuda.synchronize()
    ref_gain, ref_s, ref_d = bal.frame_gain_fwd_plain(u, *consts, frame_len)
    assert_close(gain, ref_gain, "gain")
    assert_close(s, ref_s, "s")
    assert torch.equal(primal, gain)
    # the adjoint on the same residuals (the same attack/release decisions)
    ref = bal.frame_gain_bwd_plain(s, d, gg, *consts, frame_len)
    for label, a, b in zip(("du", "dat", "drt", "dth", "dcf", "dhk"), got, ref):
        assert torch.isfinite(a).all(), label
        assert_close(a, b, label)
    assert {k: v for k, v in bal.launch_counts().items() if v} == {
        "frame_gain_core": 1, "frame_gain_fwd": 1, "frame_gain_bwd": 1}


@pytest.mark.card
def test_captured_replay_equals_the_eager_call(card):
    n, length, frame_len = SHAPES["B"]
    u, consts, gg = frame_case(card, n, length, seed=1)
    leaves = [t.clone().requires_grad_() for t in (u, *consts)]

    def call():
        # the gain detached: no autograd graph outlives a call, so the
        # capture's backward finds no node made on another stream
        gain = bal.frame_gain_core(*leaves, frame_len)
        return (gain.detach(), *torch.autograd.grad(gain, leaves, gg))

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm the caching allocator on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)
