"""Does freeing one CUDA graph while another is being captured invalidate
the capture?  ``render/compiled.py`` pauses Python's cyclic collector
during a capture because of the answer.

Graph A is captured, then left as garbage in a reference cycle, as an
optimizer and its ``CapturedFunction`` are left.  Graph B is captured
twice, each time in a fresh process: once as it is, once with a
``gc.collect()`` between two of its ops, which frees A there.  Each case
prints ``ok`` or the error of the capture.

    python scripts/capture_gc_probe.py          # needs a CUDA card
"""

import gc
import subprocess
import sys

import torch


class Cycle:
    def __init__(self):
        self.me = self


def capture_case(collect_inside):
    x = torch.ones(1024, device="cuda")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x * 2
    torch.cuda.synchronize()
    a = Cycle()
    a.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(a.graph):
        a.y = x * 2
    del a
    b = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(b):
            y = x * 3
            if collect_inside:
                gc.collect()
            y = y + 1
        b.replay()
        torch.cuda.synchronize()
        return "ok"
    except RuntimeError as e:
        return "failed: " + str(e).splitlines()[0]


def main():
    if len(sys.argv) > 1:
        print(capture_case(sys.argv[1] == "collect"), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    for case in ("plain", "collect"):
        out = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True, timeout=120)
        print(f"[capture_gc] case={case} result={out.stdout.strip()!r} rc={out.returncode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
