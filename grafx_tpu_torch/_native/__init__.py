"""Native (C++) runtime components, loaded with ctypes (the port of
:mod:`grafx_tpu._native`).

The type-scheduling beam search (``scheduler.cpp``, this package's own
copy) is compiled at first use with the system ``g++`` into
``grafx_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags (as :mod:`grafx_tpu_torch.ops._cuda` builds the
kernels), so an edited source is rebuilt and a stale build is never
loaded.  Without a compiler the numpy search of
:func:`grafx_tpu_torch.render.order.tensor.beam_search` runs instead.
Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "scheduler.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_i, _p32 = ctypes.c_int, ctypes.POINTER(ctypes.c_int32)


def _library_path():
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libscheduler_{h.hexdigest()[:16]}.so")


def build():
    """Compile the scheduler unless it is built; returns the library's
    path.  Raises where there is no ``g++`` or the compile fails."""
    path = _library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native scheduler is built from source")
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on scheduler.cpp ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def _load():
    """The loaded library, or ``None`` where it cannot be built."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    lib.grafx_beam_search.restype = _i
    lib.grafx_beam_search.argtypes = [_i, _i, _p32, _p32, _p32, _i, _i, _p32, _p32, _i]
    return lib


def native_available():
    return _load() is not None


def beam_search_native(node_types, edge_indices, width=64, depth=1):
    """Run the native beam search.

    Args:
        node_types: ``(N,)`` int array.
        edge_indices: ``(2, E)`` int array.

    Returns:
        ``(type_sequence, render_order)`` numpy arrays, or ``None`` when
        the native library is unavailable or the search fails (a cycle).
    """
    lib = _load()
    if lib is None:
        return None
    node_types = np.ascontiguousarray(node_types, dtype=np.int32)
    src = np.ascontiguousarray(edge_indices[0], dtype=np.int32)
    dst = np.ascontiguousarray(edge_indices[1], dtype=np.int32)
    N, E = len(node_types), len(src)
    max_seq = N + 2
    out_order = np.empty(N, dtype=np.int32)
    out_seq = np.empty(max_seq, dtype=np.int32)

    def ptr(a):
        return a.ctypes.data_as(_p32)

    seq_len = lib.grafx_beam_search(
        N, E, ptr(src), ptr(dst), ptr(node_types),
        int(width), int(depth), ptr(out_order), ptr(out_seq), max_seq
    )
    if seq_len < 0:
        return None
    return out_seq[:seq_len].astype(np.int64), out_order.astype(np.int64)
