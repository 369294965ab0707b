"""The headline benchmark of the port (counterpart of ``bench.py`` at the
repository's root): crowd-sim env-steps/s of the auto-resetting collector.

    python -m relationalgraphlearning_tpu_torch.tools.bench
    python -m relationalgraphlearning_tpu_torch.tools.bench --device cpu \\
        --batch 8 --horizon 4 ...                  # a small run on the CPU

The baseline (``cpu_baseline_steps_per_s``) is the reference's: ONE env on
the CPU, stepped a call at a time from Python with the linear-to-goal
action and reset when done, for 3 s. The device number is the same
simulation run the batched way: ``Explorer.collect`` of the linear robot
among ORCA humans over 1024 auto-resetting envs × 128 steps at ε = 0, a
trial being 10 collections in a row, each from the previous one's carry,
the rate the median of 5 trials. On the card a collection step is one
captured CUDA graph (as ``Explorer.collect`` runs it), and the same trials
are timed eagerly beside it. The scenarios' table is sized for every trial
before the first timed one, so that no capture falls inside a timed
region.

Prints the eager rate on a line of its own, then the reference's one JSON
line with all its keys (``bench.py:100-130``): ``"device"`` holds the
card's name and power limit, and ``extra`` the planning, chain and block
rows of ``bench_extra``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Optional

import torch

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.tools import bench_extra as be
from relationalgraphlearning_tpu_torch.training.explorer import Explorer


def linear_action(robot: torch.Tensor) -> torch.Tensor:
    """The reference baseline's action: the unit vector to the goal (zero
    at the goal)."""
    to_goal = T.goal(robot) - T.position(robot)
    d = torch.linalg.norm(to_goal, dim=-1, keepdim=True)
    return torch.where(d > 1e-6, to_goal / torch.clamp(d, min=1e-9), 0.0)


@torch.no_grad()
def cpu_baseline_steps_per_s(seconds: float = 3.0) -> float:
    """``bench.py:28-60``: one env on the CPU, a step a call, for
    ``seconds``; a finished episode resets to the next case."""
    env = CrowdSim(EnvConfig(human_policy="orca"), device="cpu")
    state, _ = env.reset([0], 0)
    out = env.step(state, linear_action(state.robot))
    n, case = 0, 1
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out = env.step(state, linear_action(state.robot))
        state = out.state
        n += 1
        if bool(out.done[0]):
            state, _ = env.reset([case], 0)
            case += 1
    return n / (time.perf_counter() - t0)


def device_steps_per_s(batch: int = 1024, horizon: int = 128,
                       repeats: int = 10, trials: int = 5, device="cuda",
                       eager_trials: Optional[int] = None) -> dict:
    """``bench.py:63-97`` (``tpu_steps_per_s``): env-steps/s of the
    collector, the median of ``trials`` trials of ``repeats`` chained
    collections of ``batch`` × ``horizon`` steps. On the card the graphed
    trials come first, then ``eager_trials`` (default ``trials``) eager
    ones over the same protocol; elsewhere only eager ones. Returns the
    rates, each trial's, the table's capacity and the kernel launches of
    one collection (none: the linear robot and ORCA run on torch ops)."""
    graphed = be.on_card(device)
    eager_trials = trials if eager_trials is None else eager_trials
    cfg = EnvConfig(human_policy="orca")
    ex = Explorer(CrowdSim(cfg, device=device),
                  make_policy("linear", PolicyConfig(), cfg, device=device),
                  0.9)
    carry = ex.init_carry(batch, 0)
    table = ex.case_table(0)

    def collect(c, mode):
        return ex.collect(c, horizon, 0, graphed=mode == "graphed")[0]

    modes = (["graphed"] if graphed else []) + (
        ["eager"] if eager_trials or not graphed else [])
    captured.reset_launch_counts()
    start = carry.case_counter.clone()
    carry = collect(carry, modes[0])             # capture + warm
    be.sync(device)
    launches = (be.times(ex.collect_graph(batch, horizon, 0).launches,
                         horizon) if graphed else captured.launch_counts())
    # The cases every timed collection may reach. Env b resets to cases
    # b, b + B, ..., so the largest counter moves by B a reset of the env
    # that resets most: room for the mean resets an env makes over the
    # runs, a tenth more, and six standard deviations of a count. A
    # collection also asks for B × horizon cases past the largest counter.
    mean = float(((carry.case_counter - start) // batch).float().mean())
    runs = repeats * (trials * graphed + eager_trials) + 1
    per_env = int(1.1 * mean * runs + 6 * math.sqrt(mean * runs + 1) + 10)
    table.ensure(int(carry.case_counter.max()) + batch * per_env
                 + batch * horizon + 1)
    capacity = table.capacity
    rates = {}
    for mode in modes:
        n = trials if mode == "graphed" else eager_trials or trials
        if mode == "eager" and graphed:
            carry = collect(carry, "eager")          # warm
        rates[mode] = []
        for _ in range(n):
            be.sync(device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                carry = collect(carry, mode)    # the carry chains
            be.sync(device)
            rates[mode].append(batch * horizon * repeats
                               / (time.perf_counter() - t0))
    if table.capacity != capacity:
        raise RuntimeError(f"the case table grew from {capacity} to "
                           f"{table.capacity} inside the timed trials")
    key = "graphed" if graphed else "eager"
    return dict(steps_per_s=statistics.median(rates[key]),
                steps_per_s_eager=(statistics.median(rates["eager"])
                                   if "eager" in rates else None),
                trials=rates, table_capacity=capacity, graphed=graphed,
                launches=launches)


def main(argv=None) -> dict:
    """Print the eager line and the reference's one line; return both
    records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where nothing is captured")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--eager_trials", type=int, default=None,
                    help="eager trials on the card (default --trials)")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="the CPU baseline's wall")
    ap.add_argument("--extra_args", default="",
                    help="bench_extra's size flags for the extra rows, as "
                         "one string (default: the reference's sizes)")
    args = ap.parse_args(argv)
    be.check_device(args.device, "bench")
    torch.backends.cuda.matmul.allow_tf32 = False
    extra_args = be.parse_args(["--device", args.device]
                               + args.extra_args.split())
    cpu = cpu_baseline_steps_per_s(args.seconds)
    dev = device_steps_per_s(args.batch, args.horizon, args.repeats,
                             args.trials, args.device,
                             eager_trials=args.eager_trials)

    ea, dv = extra_args, args.device
    plan = be.planning_throughput(ea.batch, ea.steps, dv, trials=ea.trials)
    edges = be.edges_throughput(ea.edges_n, inner=ea.inner, device=dv,
                                trials=ea.trials)
    block = be.edges_throughput_block(ea.edges_n, inner=ea.inner, device=dv,
                                      trials=ea.trials)
    block_xla = be.edges_throughput_block(ea.edges_n, inner=ea.inner,
                                          backend="xla", device=dv,
                                          trials=ea.trials)
    eager = {"metric": "env-steps/s (eager)",
             "value": (round(dev["steps_per_s_eager"], 1)
                       if dev["steps_per_s_eager"] is not None else None),
             "unit": "steps/s"}
    line = {
        "metric": "env-steps/s",
        "value": round(dev["steps_per_s"], 1),
        "unit": "steps/s",
        "vs_baseline": round(dev["steps_per_s"] / cpu, 2),
        "baseline_cpu_python_loop": round(cpu, 1),
        "batch": args.batch,
        "horizon": args.horizon,
        "trials": f"median of {args.trials}",
        "device": be.device_name(dv),
        "extra": {
            "planning_decisions_per_s_d2": round(plan["decisions_per_s"], 1),
            "planning_latency_ms": round(plan["latency_s"] * 1e3, 3),
            "relation_gedges_per_s": round(edges["edges_per_s"] / 1e9, 2),
            "relation_gedges_per_s_block": round(block["edges_per_s"] / 1e9,
                                                 2),
            "relation_gedges_per_s_block_xla": round(
                block_xla["edges_per_s"] / 1e9, 2),
            "block_coverage": block["coverage"],
        },
    }
    print(json.dumps(eager), flush=True)
    print(json.dumps(line), flush=True)
    return dict(line=line, eager=eager, collector=dev, planning=plan,
                edges=edges, block=block, block_xla=block_xla)


if __name__ == "__main__":
    main()
