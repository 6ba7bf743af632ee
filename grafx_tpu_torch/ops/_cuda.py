"""Build and load the package's CUDA kernels.

Each source under ``grafx_tpu_torch/csrc/`` is compiled at first use with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, which is loaded with ``ctypes``.  The sources build in
parallel, one ``nvcc`` process each, all started together.  A library
lands in ``grafx_tpu_torch/_build/`` under a name that carries a hash of
its source, the shared headers and the flags, so an edited source is
rebuilt and a stale build is never loaded.  Nothing here runs at import
time.
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
_HEADERS = ("ballistics.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
)

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# source -> {function: argtypes}; every function returns a cudaError_t as int
_SOURCES = {
    "ballistics_gain.cu": {
        # u, gain, consts, n, len, kind, samples, device, stream
        "grafx_gain_fwd": [_p, _p, _p, _i, _ll, _i, _i, _i, _p],
        # u, gain, d, ylast, consts, n, len, kind, samples, device, stream
        "grafx_gain_fwd_res": [_p] * 5 + [_i, _ll, _i, _i, _i, _p],
        # u, gain, consts, n, len, kind_a, kind_b, init_a, init_b, samples, device, stream
        "grafx_gain_pair_fwd": [_p] * 3 + [_i, _ll, _i, _i, _f, _f, _i, _i, _p],
        # u, gain, d_a, d_b, v_last, u_last, consts, then as above
        "grafx_gain_pair_fwd_res": [_p] * 7 + [_i, _ll, _i, _i, _f, _f, _i, _i, _p],
        # u, y, d (null: no residual), consts, n, len, samples, device, stream
        "grafx_ballistics_fwd": [_p] * 4 + [_i, _ll, _i, _i, _p],
        # u, gain, d (null: the primal), last, consts, zi, n, len, code, samples,
        # device, stream
        "grafx_chain_fwd": [_p] * 6 + [_i, _ll, _i, _i, _i, _p],
    },
    "ballistics_grad.cu": {
        # u, d, ylast, gg, consts, du, grads, partials, carry, n, len, chunk, kind,
        # device, stream
        "grafx_gain_bwd": [_p] * 9 + [_i, _ll, _i, _i, _i, _p],
        # u, d_a, d_b, lasts, gg, consts, du, scratch, grads, partials, carry, n,
        # len, chunk, kind_a, kind_b, device, stream
        "grafx_gain_pair_bwd": [_p] * 11 + [_i, _ll, _i, _i, _i, _i, _p],
        # d, g, consts, du, grads, partials, carry, n, len, chunk, device, stream
        "grafx_ballistics_bwd": [_p] * 7 + [_i, _ll, _i, _i, _p],
        # a, g, gh, carry, n, len, chunk, device, stream
        "grafx_reverse_scan": [_p] * 4 + [_i, _ll, _i, _i, _p],
        # u, d, last, gg, consts, du, grads, scratch, partials, carry, n, len,
        # chunk, code, device, stream
        "grafx_chain_bwd": [_p] * 10 + [_i, _ll, _i, _i, _i, _p],
        # blocks (out), device
        "grafx_walk_blocks_per_sm": [ctypes.POINTER(_i), _i],
    },
}


class KernelLibrary:
    """The compiled kernels, one shared library per source.
    ``build_seconds`` and ``build_log`` are the time this process spent
    compiling and the compiler's report (0.0 and empty when every library
    was already built)."""

    def __init__(self, paths, build_seconds, build_log):
        self.paths = paths
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._libs = []
        self._fns = {}
        for source, signatures in _SOURCES.items():
            lib = ctypes.CDLL(paths[source])
            self._libs.append(lib)
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self._fns[name] = fn

    def __getattr__(self, name):
        try:
            return self.__dict__["_fns"][name]
        except KeyError:
            raise AttributeError(name) from None


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


def _library_path(source):
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in (*_HEADERS, source):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(_BUILD, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build():
    """Compile the sources that are not built yet, all at once; returns
    ``({source: library path}, seconds, log)``."""
    paths = {source: _library_path(source) for source in _SOURCES}
    todo = [s for s, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths, 0.0, ""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    try:
        for source in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((source, tmp, proc))
        log, failed = [], []
        for source, tmp, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"[{source}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source} ({proc.returncode}):\n{out}")
            else:
                # atomic: a concurrent loader never sees half a file
                os.replace(tmp, paths[source])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths, time.perf_counter() - t0, "".join(log)


@functools.cache
def library():
    """The loaded :class:`KernelLibrary`, built on first call."""
    return KernelLibrary(*build())
