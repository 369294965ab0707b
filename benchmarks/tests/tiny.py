"""A cell's driver at a size a CPU test holds: the same code, with the
configuration and traffic mix cut by the driver's own ``tiny(cfg,
traffic)``; a driver without one runs at the cell's size."""

from __future__ import annotations

import copy

import torch

from benchmarks import harness


def context(cell: str, seed: int = 2 ** 31 + 977, device="cpu"):
    bench = harness.load_benchmark()
    c, entry = harness.find_cell(bench, cell)
    cfg = copy.deepcopy(harness.load_config(entry))
    tr = copy.deepcopy(harness.load_traffic(c))
    cut = getattr(harness.load_driver(tr["driver"]), "tiny", None)
    if cut is not None:
        cut(cfg, tr)
    return harness.Context(cfg, tr, seed, torch.device(device))


def run(cell: str, seed: int = 2 ** 31 + 977, control: bool = False,
        device="cpu", traced: bool = False):
    """Set-up, a window of one call, the check -> (checks, observations,
    end-to-end values). ``traced``: the port's profiling on, as in a
    ``--trace 1`` run (no profiler), and off again after."""
    ctx = context(cell, seed, device)
    driver = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    program = harness.set_up(driver, ctx.traffic, traced)
    try:
        obs = harness.Observations(ctx.config, ctx.traffic, traced)
        harness.run_window(driver, 0.0, obs, program)
    finally:
        if program is not None:
            program.disable()
            program.reset()
    e2e = driver.end_to_end(obs)
    driver.release()
    return driver.check(control=control), obs, e2e
