"""grafx_tpu_torch: the PyTorch + CUDA port of grafx_tpu.

The JAX package ``grafx_tpu`` is the reference; this package keeps its
module paths and public names.  It imports ``torch`` and never ``jax``.
Its hand-written CUDA kernels (``csrc/``) are built with ``nvcc`` at
first use on a machine with an NVIDIA Hopper GPU; on the CPU every
kernel runs as its plain PyTorch version.
"""

import torch

# On the CPU, torch.exp, log, tanh, erf, sqrt and a few more run MKL's
# vector math library, which picks its code path at its first call in a
# process.  When that first call is split over several OpenMP threads, a
# thread can start before the choice is made and compute its share on
# MKL's low-accuracy AVX2 branch (exp off by up to 1.5e-4 relative, in
# about one fresh process in thirty on an 8-core CPU under load).  One
# call on a single element runs on the calling thread alone and makes
# the choice first, so the port's CPU results depend on their inputs only
# (tests/test_torch_cpu_first_call.py).
torch.exp(torch.zeros(1))

from grafx_tpu_torch import (  # noqa: E402
    checkpoint,
    data,
    draw,
    models,
    ops,
    parallel,
    processors,
    render,
    serving,
    utils,
)

__version__ = "0.1.0"

__all__ = [
    "checkpoint",
    "data",
    "draw",
    "models",
    "ops",
    "parallel",
    "processors",
    "render",
    "serving",
    "utils",
]
