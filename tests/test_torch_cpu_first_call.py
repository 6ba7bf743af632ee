"""The port's first CPU vector-math call in a process is exact.

On the CPU, torch.exp, log, tanh, erf and sqrt run MKL's vector math
library, which picks its code path at its first call in a process.  When
that first call is split over several OpenMP threads, a thread can run
before the choice is made and compute its share on MKL's low-accuracy
AVX2 branch: exp off by up to 1.5e-4 relative.  That made
FilteredNoiseShapingReverb's render (whose envelope is an exp over
(B, C, K, ir_len)) differ from grafx_tpu's by 4.5e-5 of max|ref| in a few
fresh processes out of a hundred.  ``import grafx_tpu_torch`` makes one
single-element call on the calling thread first.

The test runs fresh processes, several at once, and compares in each the
first call, split over many threads, with the same call repeated on one
thread.  Without the import's call about one process in seven differs
(measured on an 8-core CPU), so one group of fresh processes almost
always shows it.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 32
AT_ONCE = 8

CHILD = """
import sys
import torch
import grafx_tpu_torch  # noqa: F401
fn = getattr(torch, sys.argv[1])
torch.set_num_threads(256)
x = torch.rand(4_000_000, generator=torch.Generator().manual_seed(0)) * 0.9 + 0.05
if sys.argv[1] == "exp":
    x = -10 * x
first = fn(x)
torch.set_num_threads(1)
print("same" if torch.equal(first, fn(x)) else "differs")
"""

FUNCTIONS = ("exp", "log", "tanh", "erf", "sqrt")


def test_first_split_call_after_import_equals_a_single_thread_call():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    results = []
    for start in range(0, PROCESSES, AT_ONCE):
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", CHILD, FUNCTIONS[i % len(FUNCTIONS)]],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for i in range(start, min(start + AT_ONCE, PROCESSES))
        ]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            results.append(out.strip().splitlines()[-1])
    assert results.count("differs") == 0, results

