"""The readings the limits of ``correct`` are set from, at a cell's own
size on the card: for each seed, set-up and a short window at the cell's
load, then the numbers compared for the program, for the control (the
reference in TF32 in the program's place, the precision below the
configuration's float32) and, for the training cell, for the faults read
through the reference (half of each minibatch; a state left unchanged
reads 1 by its measure and needs no run). One JSON line a seed.

    python3 benchmarks/readings.py --workload <cell> --seeds 11 12 13 \
        --seconds 5

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import harness  # noqa: E402


def readings(ctx, seconds: float) -> dict:
    driver = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    obs = harness.Observations(ctx.config, ctx.traffic)
    harness.run_window(driver, seconds, obs)
    driver.release()
    out = {"calls": obs.calls}
    for kind in ("program", "control"):
        out[kind] = {n: v for n, v, _ in driver.check(control=kind
                                                      == "control")}
    if ctx.traffic["driver"] == "train":
        lim = ctx.traffic["check"]["limits"]
        out["half_batch"] = {n: v for n, v, _ in
                             driver.check_sgd(False, lim, half=True)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    cell, entry = harness.find_cell(bench, args.workload)
    for seed in args.seeds:
        ctx = harness.Context(harness.load_config(entry),
                              harness.load_traffic(cell), seed,
                              torch.device("cuda", 0))
        print(json.dumps({"cell": args.workload, "seed": seed,
                          **readings(ctx, args.seconds)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
