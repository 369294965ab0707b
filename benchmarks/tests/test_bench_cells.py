"""Every cell of BENCHMARK.json loads by name, keeps the contract's names,
and its driver runs at a tiny size on the CPU and agrees with the plain
reference; the result line has its keys."""

import json
import re

import pytest

from benchmarks import harness
from benchmarks.tests import tiny

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_file_keeps_the_contracts_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [c["traffic"] for c in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]
                                                 + BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_finds_its_files_by_name(cell):
    c, entry = harness.find_cell(BENCH, cell)
    assert entry["file"].startswith("benchmarks/configs/")
    config = harness.load_config(entry)
    assert config["name"] == entry["name"]
    traffic = harness.load_traffic(c)
    assert harness.load_driver(traffic["driver"]).Driver
    e2e, layer = harness.cell_metrics(BENCH, cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for m in layer:
        assert callable(harness.load_metric(m["name"]).read)
        assert m["moves"] in [e["name"] for e in e2e]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_agrees_with_the_reference_on_the_cpu(cell):
    checks, obs, e2e = tiny.run(cell)
    assert harness.judge(checks), checks
    assert obs.calls == 1 and all(v >= 0 for v in e2e.values())


def test_the_result_line_has_its_keys():
    line = harness.result_line(True, 3, {"setup_s": (1.5, "s")},
                               {"platform": "gpu"}, None,
                               [("gap", 0.0, 1e-4)])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"gap": {"value": 0.0, "limit": 1e-4}}
    assert harness.check_lines([("gap", 0.5, 0.25)]) == [
        "check gap 0.5 limit 0.25"]
    assert not harness.judge([("gap", float("nan"), 1.0)])
