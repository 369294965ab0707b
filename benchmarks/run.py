"""Run one cell of the benchmark once and print its result line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (building the program's objects from
the cell's configuration and traffic mix, loading or drawing the weights,
warming every shape the traffic uses, capturing its graphs) counts in
``setup_s``, from the start of this process to the first timed call. The
window then calls the cell's driver until ``--seconds`` have passed. With
``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` the line holds the per-layer metrics (the window's spans and
counters, the harness's and the port's own), and the profiler records a
short stretch of further calls for the device's busy time, the per-kernel
metrics and a breakdown. After the window the peak memory is read, the
program's state freed, and the plain reference judges a seeded sample of
what the timed path produced: each compared number is printed beside its
limit, as the last lines on standard error and under ``checks``, the
result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import harness  # noqa: E402
from benchmarks.tracing import Tracer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    cell, entry = harness.find_cell(bench, args.workload)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # float32 as the configurations state it: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = harness.Context(harness.load_config(entry),
                          harness.load_traffic(cell), args.seed,
                          torch.device("cuda", 0))
    driver = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    program = harness.set_up(driver, ctx.traffic, bool(args.trace))
    torch.cuda.synchronize()

    obs = harness.Observations(ctx.config, ctx.traffic, bool(args.trace))
    setup_s = time.perf_counter() - T_START
    harness.run_window(driver, args.seconds, obs, program)
    if args.trace:
        harness.run_traced(driver, Tracer(ctx.traffic["trace_seconds"]), obs,
                           program)
    peak = torch.cuda.max_memory_allocated()

    e2e, layer = harness.cell_metrics(bench, args.workload)
    if args.trace:
        values = {}
        for m in layer:
            v = harness.load_metric(m["name"]).read(obs)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
    else:
        measured = driver.end_to_end(obs)
        measured["setup_s"] = setup_s
        values = {m["name"]: (measured[m["name"]], m["unit"]) for m in e2e}

    driver.release()
    torch.cuda.empty_cache()
    checks = driver.check()
    correct = harness.judge(checks)

    found = harness.forbidden_modules()
    if found:
        print(f"the measured process holds {found}", file=sys.stderr)
        return 3

    line = harness.result_line(
        correct, obs.calls, values,
        harness.device_info(torch, cell["chips"], peak, obs.trace),
        obs.trace, checks)
    for text in harness.check_lines(checks):
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
