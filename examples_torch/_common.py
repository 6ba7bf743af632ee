"""What the examples share: the device they run on and how they time."""

import time

import torch


def add_device_argument(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="the card by default (raises where torch sees none); 'cpu' runs on the CPU",
    )


def timed_ms(fn, device):
    """``(ms, result)`` of one call of ``fn``: CUDA events on the card (the
    card's timeline, waits for the host included), the host clock on the
    CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end), out
    start = time.perf_counter()
    out = fn()
    return (time.perf_counter() - start) * 1e3, out
