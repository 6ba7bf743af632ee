"""grafx_tpu_torch: the PyTorch + CUDA port of grafx_tpu.

The JAX package ``grafx_tpu`` is the reference; this package keeps its
module paths and public names.  It imports ``torch`` and never ``jax``.
Its hand-written CUDA kernels (``csrc/``) are built with ``nvcc`` at
first use on a machine with an NVIDIA Hopper GPU; on the CPU every
kernel runs as its plain PyTorch version.
"""

from grafx_tpu_torch import (
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
