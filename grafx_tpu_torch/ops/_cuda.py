"""Build and load the package's CUDA kernels.

The sources under ``grafx_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain
C interface, which is loaded with ``ctypes``.  The library lands in
``grafx_tpu_torch/_build/`` under a name that carries a hash of the
sources, so an edited source is rebuilt and a stale build is never
loaded.  Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("ballistics_gain.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
)

_c_ptr, _c_int, _c_ll, _c_float = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
)
_SIGNATURES = {
    # u, gain, consts, n, len, kind, device, stream
    "grafx_gain_fwd": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll, _c_int, _c_int, _c_ptr],
    # u, gain, scratch, consts, n, len, kind_a, kind_b, init_a, init_b, device, stream
    "grafx_gain_pair_fwd": [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ll, _c_int, _c_int,
        _c_float, _c_float, _c_int, _c_ptr,
    ],
}


class KernelLibrary:
    """The compiled kernels; ``build_seconds`` and ``build_log`` are the
    time this process spent compiling and the compiler's report (0.0 and
    empty when the library was already built)."""

    def __init__(self, path, build_seconds, build_log):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    path = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin"
            " and PATH); the CUDA kernels are built from source at first use."
        )
    return path


def _source_digest():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if needed; returns ``(path, seconds, log)``."""
    path = os.path.join(_BUILD, f"libgrafx_kernels_{_source_digest()}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(_BUILD, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
        cmd += [os.path.join(_CSRC, name) for name in _SOURCES]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def library():
    """The loaded :class:`KernelLibrary`, built on first call."""
    return KernelLibrary(*build())
