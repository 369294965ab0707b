"""The benchmark's frame: it finds a cell's configuration, traffic mix,
driver and per-layer metrics by name, times the measured window, and prints
the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters, and ``"driver"``, the
  name of the module ``drivers/<driver>.py`` that runs it;
- ``metrics/<metric>.py``: a reader ``read(obs) -> float | None`` of one
  per-layer metric from the traced run's ``Observations``.

A driver module may give ``tiny(cfg, traffic)``, its cut to a CPU test's
size (``tests/tiny.py``). So a cell, a configuration or a metric is added
as new files and new entries, and no file here changes.

A traced run (``--trace 1``) also switches on the port's own spans,
counters and device phases (``utils/profiling.py``) and hands the window's
snapshot of them to the readers as ``obs.program``; an untraced run, which
gives every end-to-end number, never touches them.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names the measured process may not hold: the JAX stack
# and the JAX package the port was made from. Compared whole: the port's own
# name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "relationalgraphlearning_tpu")


# ------------------------------------------------------------------ finding
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """The cell ``name`` and its configuration's entry."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return load_json(root / entry["file"])


def load_traffic(cell: dict) -> dict:
    return load_json(BENCH / "traffic" / f"{cell['traffic']}.json")


def import_file(path: Path, name: str):
    """A module from its file (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"benchmarks.drivers.{name}")


def load_metric(name: str):
    return import_file(BENCH / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics the cell reports: an end-to-end
    metric where its ``workloads`` name the cell (or it has none); a
    per-layer metric where its ``workloads`` name the cell."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds (the port's nvcc builds go to its own
    ``_build/`` inside the checkout)."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


# ------------------------------------------------------------------- window
class Context:
    """What a driver is given: the configuration and traffic mix as read,
    the seed and the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device


class Observations:
    """What the per-layer readers read: host spans (seconds, by name),
    counters, other per-call samples (by name), the window's length and
    calls, the traced window's ``TraceSummary`` and the port's own spans,
    counters and device phases over the window (each None in an untraced
    run), beside the cell's configuration and traffic mix."""

    def __init__(self, config: Optional[dict] = None,
                 traffic: Optional[dict] = None, traced: bool = False):
        self.config, self.traffic = config or {}, traffic or {}
        self.traced = traced  # a --trace 1 run
        self.spans: dict = {}
        self.counters: dict = {}
        self.samples: dict = {}
        self.window_s = 0.0
        self.calls = 0
        self.trace = None
        self.program = None  # the port's profiling.snapshot() of the window


class Window:
    """The measured window: host-clock spans around the calls into each
    layer (a ``record_function`` range too while the profiler records, so
    the trace can name what the host was doing), and the boundaries at
    which a traced window may close."""

    def __init__(self, obs: Observations, tracer=None):
        self.obs, self.tracer = obs, tracer

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.tracer is not None and self.tracer.active:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.obs.spans.setdefault(name, []).append(dt)

    def count(self, name: str, n: float) -> None:
        self.obs.counters[name] = self.obs.counters.get(name, 0) + n

    def sample(self, name: str, value: float) -> None:
        self.obs.samples.setdefault(name, []).append(value)

    def boundary(self) -> None:
        if self.tracer is not None:
            self.tracer.tick()


def set_up(driver, traffic: dict, traced: bool):
    """``driver.setup()`` -> the port's profiling module in a traced run
    (switched on), else None. It is switched on after set-up, so that the
    graphs set-up captures hold the same nodes as in an untraced run, or
    before it where the mix asks for device phases (``"phases": true``),
    which a graph records only when it is captured with the switch on."""
    program = None
    if traced:
        from relationalgraphlearning_tpu_torch.utils import profiling
        program = profiling
        if traffic.get("phases"):
            program.enable()
    driver.setup()
    if program is not None:
        program.enable()
    return program


def run_window(driver, seconds: float, obs: Observations, program=None
               ) -> tuple[float, float]:
    """Calls ``driver.call(window)`` until ``seconds`` have passed (the call
    that crosses the end completes; each ends in a sync) -> (start, end)
    on the host clock. ``program``: the port's profiling module, emptied
    before the window and read into ``obs.program`` after it."""
    win = Window(obs)
    if program is not None:
        program.reset()
    t0 = time.perf_counter()
    while True:
        driver.call(win)
        obs.calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    obs.window_s = t1 - t0
    if program is not None:
        obs.program = program.snapshot()
    return t0, t1


def run_traced(driver, tracer, obs: Observations, program=None) -> None:
    """After the window: further calls under the profiler until its budget
    has passed (closing at a call's boundary) -> ``obs.trace``, and the
    calls it covered in ``obs.counters["traced_calls"]``. The port's spans
    (``program``'s) name idle gaps beside the driver's own."""
    tobs = Observations(obs.config, obs.traffic)
    win = Window(tobs, tracer)
    tracer.start()
    while tracer.active:
        driver.call(win)
        tobs.calls += 1
        win.boundary()
    obs.counters["traced_calls"] = tobs.calls
    names = set(tobs.spans)
    if program is not None:
        names |= set(program.snapshot()["spans"])
    obs.trace = tracer.summary(names)


# ------------------------------------------------------------------- checks
def judge(checks: list) -> bool:
    """Every compared number at or below its limit (a NaN fails)."""
    return all(not math.isnan(v) and v <= lim for _, v, lim in checks)


def check_lines(checks: list) -> list:
    return [f"check {n} {v!r} limit {lim!r}" for n, v, lim in checks]


def _finite(v: float) -> float:
    """A number JSON can hold: a NaN or an infinity reads 1e30 (and has
    already failed ``judge``)."""
    return v if math.isfinite(v) else 1e30


def check_dict(checks: list) -> dict:
    return {n: {"value": _finite(v), "limit": lim} for n, v, lim in checks}


def result_line(correct: bool, attempted: int, values: dict, device: dict,
                trace=None, checks: tuple = ()) -> dict:
    """The run's result: ``values`` {metric: (value, unit)}; the checks'
    numbers and limits under the last key."""
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in values.items()},
            "device": device}
    if trace is not None:
        line["breakdown"] = trace.breakdown()
    line["checks"] = check_dict(checks)
    return line


def device_info(torch, count: int, peak: int,
                trace: Optional[object] = None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": peak}
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    return d
