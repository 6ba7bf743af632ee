"""The forward walks built with links of 1, 2, 4 and 8 samples, timed on
one NVIDIA GPU at the console's shapes.

The package builds its forward walks with links of ``WALK_LINK`` = 8
samples (``kLink`` in ``grafx_tpu_torch/csrc/ballistics.cuh``).  For each
link length this script copies the kernel sources into a directory of
its own under ``grafx_tpu_torch/_build/link_sweep/``, sets ``kLink``
there, compiles ``ballistics_gain.cu`` (every forward walk) alone, and
times #1 and #3 at 68 x 2^17, #2 and #5 at 8 x 2^17 and #7 at 68 x 2^17
in that build (``chip_smoke.link_timings``: each held to its plain
version, with its cycles a sample).  The adjoints are the package's own
build.

    python3 scripts/walk_link_sweep.py [--links 1 2 4 8]

Prints a line a kernel and build, and the card as ``nvidia-smi`` names
it.
"""

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from grafx_tpu_torch.ops import _cuda  # noqa: E402

LINK_LINE = "constexpr int kLink = 8;"


def build_with_link(link):
    """The path of ``ballistics_gain.cu`` built with links of ``link``
    samples, in a directory of its own."""
    src = os.path.join(_cuda._BUILD, "link_sweep", f"link{link}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda._CSRC, src)
    header = os.path.join(src, "ballistics.cuh")
    with open(header) as f:
        text = f.read()
    if LINK_LINE not in text:
        raise RuntimeError(f"{header}: no line {LINK_LINE!r} to set the link in")
    with open(header, "w") as f:
        f.write(text.replace(LINK_LINE, f"constexpr int kLink = {link};"))
    lib = os.path.join(src, "libballistics_gain.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib,
                    os.path.join(src, "ballistics_gain.cu")], check=True)
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    own, _, _ = _cuda.build()
    package_library = _cuda.library
    gen = torch.Generator(device="cuda").manual_seed(20)
    (pair, _), (bus, _) = chip_smoke.console_cases(gen)[:2]
    walk = chip_smoke.walk_args(gen, chip_smoke.BATCH * chip_smoke.CHAINS, chip_smoke.AUDIO_LEN)
    try:
        for link in args.links:
            paths = {**own, "ballistics_gain.cu": build_with_link(link)}
            lib = _cuda.KernelLibrary(paths, 0.0, "")
            _cuda.library = lambda lib=lib: lib
            chip_smoke.link_timings(pair, bus, walk, link)
    finally:
        _cuda.library = package_library


if __name__ == "__main__":
    main()
