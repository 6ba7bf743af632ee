"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also end standard error.  Without a CUDA device, or with
fewer cards than the cell asks for, it exits with an error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")

    from portbench import harness

    harness.fixed_caches(ROOT)
    harness.gpu_or_exit(cells[args.workload]["chips"])
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines, _ = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in this process: {', '.join(bad)}")
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
