"""A cell's driver at a size a CPU test holds: the same code, with the
configuration and traffic mix cut here only."""

from __future__ import annotations

import copy

import torch

from benchmarks import harness


def context(cell: str, seed: int = 2 ** 31 + 977, device="cpu"):
    bench = harness.load_benchmark()
    c, entry = harness.find_cell(bench, cell)
    cfg = copy.deepcopy(harness.load_config(entry))
    tr = copy.deepcopy(harness.load_traffic(c))
    if tr["driver"] == "train":
        tr.update(train_envs=2, collect_steps=4, case_table=64)
        tr["check"].update(iterations=1, transitions=3, sweeps=1)
        cfg["buffer_fill"] = 16
        cfg["env"]["time_limit"] = 1.0  # the window's call ends episodes
        cfg["train"].update(train_batches=2, capacity=1000)
    elif tr["driver"] in ("eval", "decide"):
        tr["cases"] = 3
        cfg["env"]["time_limit"] = 2.5
        tr["check"].update(states=4, decisions=1000)
    else:
        cfg["crowd"]["agents"] = 512
        tr.update(block_B=64, block_C=448, steps_per_call=4, rebuild_every=2)
    return harness.Context(cfg, tr, seed, torch.device(device))


def run(cell: str, seed: int = 2 ** 31 + 977, control: bool = False,
        device="cpu"):
    """Set-up, a window of one call, the check -> (checks, observations,
    end-to-end values)."""
    ctx = context(cell, seed, device)
    driver = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    obs = harness.Observations(ctx.config, ctx.traffic)
    harness.run_window(driver, 0.0, obs)
    e2e = driver.end_to_end(obs)
    driver.release()
    return driver.check(control=control), obs, e2e
