"""``BENCHMARK.json`` against its format (names, units, keys, bounds, the run
length a full check of 24 cells allows), and every cell's files found by name."""

import json
import math
import os
import re

import pytest

from portbench import harness
from portbench.reference import graph

ROOT = os.path.dirname(harness.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check of 24 cells fits its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert all(c in e2e[m["moves"]].get("workloads", CELLS) for c in m["workloads"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.Cell(BENCH, cell)
    assert c.mode in ("train", "serve") and c.spec["chips"] == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"].split(".")[0] + ".py"))
    for spec in c.config["processors"].values():
        assert graph.module(spec).parameter_size(spec["args"])
    checks = {"train": [{"loss_gap", "grad_gap", "change_gap"}],
              "serve": [{"out_err"}, {"out_err_hf"}]}[c.mode]
    assert set(c.limits) in checks
    for v in c.limits.values():
        assert 0 < v["limit"] < math.inf


# the gain-smoothed console's compressor and gate over bench_processors("exact")
GAIN_SMOOTHED = {
    "compressor": {"class": "Compressor", "reference": "GainSmoothedCompressor",
                   "args": {"energy_smoother": "ballistics", "gain_smoother": "ballistics"}},
    "noisegate": {"class": "NoiseGate", "reference": "GainSmoothedNoiseGate",
                  "args": {"energy_smoother": "iir_exact", "gain_smoother": "ballistics",
                           "gain_smooth_in_log": True}},
}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_bench_console(config):
    """The configuration's graph is ``bench_graph(17)``'s, node for node;
    ``console17_gs``'s processors are ``console17_exact``'s with the
    gain-smoothed compressor and gate."""
    from grafx_tpu_torch.models.console import bench_graph, bench_processors

    spec = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, spec["file"])) as f:
        cfg = json.load(f)
    G = bench_graph(17)
    assert cfg["nodes"] == [G.nodes[n]["node_type"] for n in sorted(G.nodes)]
    assert sorted(map(tuple, cfg["edges"])) == sorted(G.edges())
    backend = cfg["processors"]["eq"]["args"]["backend"]
    procs = bench_processors(backend)
    for t, p in cfg["processors"].items():
        assert type(procs[t]).__name__ == p["class"]
    if config == "console17_gs":
        with open(os.path.join(harness.HERE, "configs", "console17_exact.json")) as f:
            exact = json.load(f)["processors"]
        assert cfg["processors"] == {**exact, **GAIN_SMOOTHED}
    else:
        assert not any("reference" in p for p in cfg["processors"].values())
    assert cfg["reduced"] == spec["reduced"] == []


def test_module_is_the_class_unless_named():
    """A processor entry's reference module is ``reference/<class>.py``,
    or the module its ``"reference"`` key names."""
    assert graph.module({"class": "Compressor", "args": {}}).__name__ == \
        "portbench.reference.Compressor"
    assert graph.module(GAIN_SMOOTHED["compressor"]).__name__ == \
        "portbench.reference.GainSmoothedCompressor"
