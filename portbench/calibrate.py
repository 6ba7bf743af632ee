"""Read the numbers a cell's limits are set from, in one process on the
card: the program's on many seeds (each a whole run: set-up, a short
window, the comparison), the control's (``configs/*.json``: ``control``,
the reference in that precision in the program's place) and, for a
training cell, the half-batch fault's (the reference with its loss over
half the mixes in the program's place) on the first few.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--faults 3] [--seconds 2] [--out <file.jsonl>]

Prints, and appends to ``--out``, one JSON line per seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    harness.fixed_caches(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # the cell's numbers with no limit; a serve cell's whole-band error besides
    unbounded = {k: {**v, "limit": float("inf")}
                 for k, v in harness.Cell(bench, args.workload).limits.items()}
    if "out_err_hf" in unbounded:
        unbounded["out_err"] = {"limit": float("inf")}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        _, _, run = harness.run_cell(bench, args.workload, seed, args.seconds, False, args.device,
                                     start, limits=unbounded)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v["value"] for k, v in run.checks.items()},
                "notes": run.notes, "calls": run.done, "setup_s": run.setup_s,
                "reference_s": run.check_s}
        if i < args.faults:
            t = time.perf_counter()
            line["control"], line["control_notes"] = run.numbers(control=run.cell.config["control"])
            line["control_s"] = time.perf_counter() - t
            if run.cell.mode == "train":
                line["half_batch"], line["half_batch_notes"] = run.numbers(half_batch=True)
        line["seconds"] = time.perf_counter() - start
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in this process: {', '.join(bad)}")


if __name__ == "__main__":
    main()
