"""On the card, at each cell's own size with a 10-s window: the program
comes out correct and the control (the reference in TF32 in its place)
does not. Marked ``cuda``; skipped where there is no card."""

import pytest
import torch

from benchmarks import harness
from benchmarks.readings import readings

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    c, entry = harness.find_cell(BENCH, cell)
    ctx = harness.Context(harness.load_config(entry), harness.load_traffic(c),
                          2 ** 31 + 4242, card)
    limits = ctx.traffic["check"]["limits"]  # a number not there is exact
    out = readings(ctx, 10.0)  # the training window reaches its picked sweep
    torch.cuda.empty_cache()
    assert all(v <= limits.get(n, 0.0) for n, v in out["program"].items()), out
    assert any(v > limits.get(n, 0.0) for n, v in out["control"].items()), out
