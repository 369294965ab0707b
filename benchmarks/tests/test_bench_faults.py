"""With the timed path broken underneath, the rest of a run comes out not
correct: a step that returns its state unchanged, half of the batch left
out (the mean over the rest), an answer altered where it is produced. Each
fault is planted in the program on the CPU at a tiny size, every fault of
the cell's driver (``tests/faults/<driver>.py``) in every cell that runs
it; the one chip of every cell leaves no exchange between chips to leave
out."""

import importlib

import pytest

from benchmarks import harness
from benchmarks.tests import tiny
from benchmarks.tests.faults import train as train_faults

BENCH = harness.load_benchmark()


def driver_of(cell: str) -> str:
    return harness.load_traffic(harness.find_cell(BENCH, cell)[0])["driver"]


def faults(driver: str) -> dict:
    return importlib.import_module(f"benchmarks.tests.faults.{driver}").FAULTS


CELLS = [c["name"] for c in BENCH["workloads"]]
CASES = [(cell, name, plant) for cell in CELLS
         for name, plant in faults(driver_of(cell)).items()]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cells_driver_plants_an_altered_answer(cell):
    assert "answer altered" in faults(driver_of(cell))


@pytest.mark.parametrize("cell,fault,plant", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    checks, _, _ = tiny.run(cell)
    assert not harness.judge(checks), checks


def test_a_fault_in_the_window_sweeps_alone_is_not_correct(monkeypatch):
    """Half of each minibatch left out from the window on (set-up's first
    steps sound): the picked window sweep's numbers fail."""
    ctx = tiny.context("mp_rgl.train")
    driver = harness.load_driver(ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    train_faults.half_minibatch(monkeypatch)
    harness.run_window(driver, 0.0, harness.Observations(ctx.config,
                                                         ctx.traffic))
    driver.release()
    failed = {n for n, v, lim in driver.check() if not harness.judge(
        [(n, v, lim)])}
    assert failed & {"sweep_loss_rel", "sweep_grad_median_gap",
                     "sweep_update_median_gap"}, failed
    assert not failed & {"first_loss_rel", "first_grad_median_gap",
                         "update_median_gap"}, failed
