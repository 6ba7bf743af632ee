"""The yardstick's counters against hand counts on a 3-chain console, and
the trace's reductions and the metric readers on made-up events."""

import json
import math
import os
import types

import pytest

from portbench import harness, trace
from portbench.metrics import device_ops, idle_share, mfu, walk_ms, walk_roofline
from portbench.reference import graph

SMALL = os.path.join(os.path.dirname(__file__), "console3.json")


def small_config(backend):
    with open(os.path.join(harness.HERE, "configs", f"console17_{backend}.json")) as f:
        cfg = json.load(f)
    with open(SMALL) as f:
        cfg.update(json.load(f))
    return cfg


def fft_conv(rows, length, taps):
    n = 1 << (length + taps - 2).bit_length()
    return rows * (3 * 2.5 * n * math.log2(n) + 3 * n)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backend", ["exact", "fsm"])
def test_counts_by_hand(backend, train):
    B, C, L = 3, 2, 2**12
    cfg = small_config(backend)
    # 4 eq, 4 geq (2 on the buses), 1 gate, 5 compressors (2 on the buses),
    # 4 gains, 1 distortion, 1 reverb; the mixes sum 1 + 1 + 2 pairs
    if backend == "exact":
        eq, geq = 4 * B * C * L * 9 * 6, 4 * B * C * L * 9 * 24
    else:
        eq = geq = 4 * fft_conv(B * C, L, 4000)
    dyn = 1 * B * L * 18 + 5 * B * L * 19
    frames = 1 + 30000 // 192
    reverb = B * 2 * frames * (2.5 * 384 * math.log2(384) + 4 * 384) + fft_conv(B * C, L, 30000)
    flops = eq + geq + dyn + 4 * B * C * L + 3 * B * C * L + reverb + 4 * B * C * L
    walk = 6 * 4 * B * L * (5 if train else 2)
    if train:
        flops = 3 * flops + 3 * B * C * L
    got = graph.count(cfg, B, L, train)
    assert got[0] == pytest.approx(flops, rel=1e-12)
    assert got[1] == walk


def test_schedule_respects_edges_and_batches_types():
    cfg = small_config("exact")
    batches, preds = graph.schedule(cfg["nodes"], cfg["edges"])
    done = set()
    for kind, nodes in batches:
        assert all(cfg["nodes"][n] == kind for n in nodes)
        assert all(p in done for n in nodes for p in preds[n])
        done |= set(nodes)
    assert done == set(range(len(cfg["nodes"])))
    # the three source compressors run as one batch
    assert ("compressor", [4, 9, 14]) in batches


def ctx_of(device, window_s=1.0, calls=2):
    layers = trace.kernel_layers(os.path.join(harness.HERE, "kernels"))
    return types.SimpleNamespace(
        device=device, calls=calls, window_s=window_s, busy_s=trace.busy_us(device) / 1e6,
        layers=layers, walk_bytes=3.35e9, flops=67e9, seconds_per_call=0.5,
        peaks={"bytes_per_s": 3.35e12, "float32_flops_per_s": 67e12})


def test_trace_reductions_and_readers():
    device = [
        ("void pair_kernel(float const*, float*, int)", 0.0, 100_000.0),
        ("void at::native::reduce_kernel<512, 1>(float*)", 50_000.0, 100_000.0),
        ("(anonymous namespace)::rwalk_kernel(float const*)", 300_000.0, 100_000.0),
        ("void regular_fft_factor<256>(float2*)", 500_000.0, 100_000.0),
    ]
    host = [("cudaStreamSynchronize", 140_000.0, 200_000.0), ("portbench.step", 0.0, 900_000.0)]
    assert trace.intervals(device) == [[0.0, 150_000.0], [300_000.0, 400_000.0],
                                       [500_000.0, 600_000.0]]
    assert trace.busy_us(device) == 350_000.0
    ctx = ctx_of(device)
    assert device_ops.read("device_ops.train", ctx) == 2.0
    assert walk_ms.read("walk_ms.train", ctx) == pytest.approx(100.0)  # 200 ms over 2 calls
    assert walk_roofline.read("walk_roofline.train", ctx) == pytest.approx(1.0)
    assert idle_share.read("idle_share.train", ctx) == pytest.approx(65.0)
    assert mfu.read("mfu.train", ctx) == pytest.approx(0.2)
    b = trace.breakdown(device, host)
    assert b["device_ops"][0][1] == pytest.approx(0.1)
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(0.15)]
    assert b["idle_gaps"][1] == ["portbench.step", pytest.approx(0.1)]


def test_readers_find_nothing_and_say_so():
    ctx = ctx_of([("void at::native::vectorized_elementwise_kernel<4>(int)", 0.0, 10.0)])
    assert walk_ms.read("walk_ms.serve", ctx) is None
    assert walk_roofline.read("walk_roofline.serve", ctx) is None
