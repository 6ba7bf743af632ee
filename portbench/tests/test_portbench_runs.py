"""Whole runs at a small size on the CPU (the look for a card skipped):
the port against the reference, the faults the comparison must catch, the
control, and no JAX module loaded."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
with open(os.path.join(os.path.dirname(__file__), "console3.json")) as f:
    SMALL = json.load(f)
# the small size's own limits: some times the port's readings at this size
# (out_err 8e-4 and 5e-4; loss, gradient and change gaps 2e-7, 1.3e-4, 2e-3)
LIMITS = {"out_err": {"limit": 5e-3}, "out_err_hf": {"limit": 5e-3, "above_hz": 1000},
          "loss_gap": {"limit": 1e-5},
          "grad_gap": {"limit": 2e-3}, "change_gap": {"limit": 2e-2}}
SEED = 2**31 + 11


def run(cell, fault=None):
    names = harness.Cell(BENCH, cell).limits
    return harness.run_cell(BENCH, cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                            overrides=SMALL, fault=fault, limits={k: LIMITS[k] for k in names})


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_port_agrees_with_the_reference(cell):
    result, lines, _ = run(cell)
    assert result["correct"], lines
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in harness.Cell(BENCH, cell).end_to_end}


FAULTS = [(w["name"], f) for w in BENCH["workloads"]
          for f in (("unchanged_state", "half_batch") if w["traffic"] == "train"
                    else ("altered_answer",))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, lines, _ = run(cell, fault)
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(cell):
    """The reference in the configuration's control precision, in the
    port's place, fails one of the cell's own limits at this size too."""
    _, _, r = run(cell)
    numbers, _ = r.numbers(control=r.cell.config["control"])
    limits = harness.Cell(BENCH, cell).limits
    assert any(numbers[k] > limits[k]["limit"] for k in limits), numbers


def test_the_trainer_reads_its_state_as_the_optimizer_got_it():
    _, _, r = run("console17_exact.train")
    assert len(r.prog["losses"]) == r.cell.traffic["check_steps"]
    assert set(r.prog["grad"]) == set(r.ref["grad"]) == set(r.prog["change"])


def test_no_jax_module_is_loaded():
    code = ("import sys, time; sys.path.insert(0, {root!r});"
            "from portbench.tests.test_portbench_runs import run;"
            "from portbench import harness;"
            "r = run('console17_fsm.serve');"
            "print(','.join(harness.forbidden_modules()) or 'none')").format(root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_the_command_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("torch sees a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "console17_exact.train", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
