"""Every cell of BENCHMARK.json loads by name, keeps the contract's names,
and its driver runs at a tiny size on the CPU and agrees with the plain
reference; a cell with a driver of its own runs with no edit here; a traced
run hands the port's own spans to the readers that read them; the result
line has its keys."""

import copy
import json
import re
import sys
import types

import pytest

from benchmarks import harness
from benchmarks.drivers import eval as eval_driver
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


# What each driver's ``tiny`` cuts, key by key: the CPU sizes the cells had
# when the cuts lived in tests/tiny.py, less the two keys that a driver
# never read (eval's ``check.decisions``, decide's ``check.states``).
CUTS = {
    "mp_rgl.train": {
        "traffic": {"train_envs": 2, "collect_steps": 4, "case_table": 64,
                    "check": {"iterations": 1, "transitions": 3,
                              "sweeps": 1}},
        "config": {"buffer_fill": 16, "env": {"time_limit": 1.0},
                   "train": {"train_batches": 2, "capacity": 1000}}},
    "mp_rgl.eval500": {
        "traffic": {"cases": 3, "check": {"states": 4}},
        "config": {"env": {"time_limit": 2.5}}},
    "mp_rgl.decide_b1": {
        "traffic": {"cases": 3, "check": {"decisions": 1000}},
        "config": {"env": {"time_limit": 2.5}}},
    "crowd10k.block_r8": {
        "traffic": {"block_B": 64, "block_C": 448, "steps_per_call": 4,
                    "rebuild_every": 2},
        "config": {"crowd": {"agents": 512}}},
}


def merged(full: dict, cut: dict) -> dict:
    out = copy.deepcopy(full)
    for k, v in cut.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_tiny_gives_the_cells_their_cpu_sizes(cell):
    c, entry = harness.find_cell(BENCH, cell)
    ctx = tiny.context(cell)
    assert ctx.traffic == merged(harness.load_traffic(c),
                                 CUTS[cell]["traffic"])
    assert ctx.config == merged(harness.load_config(entry),
                                CUTS[cell]["config"])


def test_a_driver_tiny_does_not_name_runs_through_it(monkeypatch):
    """A new cell whose driver is a module of its own, found by the name
    its traffic gives: ``tiny`` takes the driver's own cut, and the cell
    runs and agrees with the reference, with no file of the harness
    edited."""
    stub = types.ModuleType("benchmarks.drivers.stub_eval")

    class Driver(eval_driver.Driver):
        pass

    cut = []
    stub.Driver = Driver
    stub.tiny = lambda cfg, tr: (cut.append(True),
                                 eval_driver.tiny(cfg, tr))
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "mp_rgl.stub", "config": "mp_rgl",
                               "traffic": "stub", "chips": 1, "why": "a"})
    traffic = dict(harness.load_traffic({"traffic": "eval500"}),
                   driver="stub_eval")
    load_traffic = harness.load_traffic
    monkeypatch.setattr(harness, "load_benchmark", lambda *a: bench)
    monkeypatch.setattr(harness, "load_traffic", lambda c: copy.deepcopy(
        traffic) if c["traffic"] == "stub" else load_traffic(c))
    checks, obs, e2e = tiny.run("mp_rgl.stub")
    assert cut and obs.traffic["cases"] == 3
    assert harness.judge(checks), checks
    assert obs.calls == 1 and e2e["eval_env_steps_per_s"] > 0


SPAN_METRICS = [(m["name"], cell) for m in BENCH["per_layer"]
                if m["source"] == "program_span" for cell in m["workloads"]]


@pytest.mark.parametrize("metric,cell", SPAN_METRICS,
                         ids=[f"{m}-{c}" for m, c in SPAN_METRICS])
def test_a_traced_run_hands_the_ports_spans_to_their_readers(metric, cell):
    """The port's profiling on after set-up (as in a ``--trace 1`` run):
    the metric reads a positive number from the window's snapshot; off
    after the run, and an untraced run has no snapshot."""
    from relationalgraphlearning_tpu_torch.utils import profiling
    _, obs, _ = tiny.run(cell, traced=True)
    assert not profiling.enabled()
    value = harness.load_metric(metric).read(obs)
    assert value is not None and value > 0, obs.program
    obs.program = None
    assert harness.load_metric(metric).read(obs) is None


@pytest.mark.parametrize("traced,phases,before,after", [
    (False, False, False, False), (False, True, False, False),
    (True, False, False, True), (True, True, True, True)])
def test_set_up_switches_the_ports_profiling(traced, phases, before, after):
    """Off in an untraced run; in a traced one on after set-up, or before
    it where the mix asks for device phases."""
    from relationalgraphlearning_tpu_torch.utils import profiling

    class Driver:
        def setup(self):
            self.during = profiling.enabled()

    d = Driver()
    try:
        program = harness.set_up(d, {"phases": phases}, traced)
        assert (d.during, profiling.enabled()) == (before, after)
        assert (program is profiling) == traced
    finally:
        profiling.disable()


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
