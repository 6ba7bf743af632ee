"""``grafx_tpu_torch.profiling`` on the CPU: ``time_fn`` gives positive
seconds, ``trace`` writes a Chrome trace, ``device_time_ms`` sums the
traced block's leaf ops (on the card, its device ops).  The card's
numbers come from ``chip_smoke.py`` phase 31."""

import json
import os

import pytest
import torch

from grafx_tpu_torch import profiling


def work(x):
    return torch.fft.irfft(torch.fft.rfft(x) * 2.0, n=x.shape[-1])


@pytest.mark.parametrize("vary", [True, False])
def test_time_fn_positive(vary):
    x = torch.randn(16, 4096)
    calls = []

    def fn(a):
        calls.append(a)
        return work(a)

    seconds = profiling.time_fn(fn, x, iters=3, vary=vary)
    assert seconds > 0
    assert len(calls) == 4  # a warm-up and three timed calls
    assert all(torch.equal(c, x) for c in calls) != vary


def test_trace_writes_chrome_trace(tmp_path):
    x = torch.randn(8, 1024)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        work(x)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in e.get("name", "") for e in events)
    assert profiling.trace_device_total_ms(log_dir) == 0.0  # no device events on the CPU


def test_device_time_ms_positive(tmp_path):
    x = torch.randn(64, 8192)
    ms = profiling.device_time_ms(lambda: work(x), log_dir=str(tmp_path))
    assert ms > 0
    assert len(os.listdir(tmp_path)) == 1


def test_trace_device_total_ms_needs_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.trace_device_total_ms(str(tmp_path))
