"""The port's unicycle failure breakdown against the JAX package's
(``tools/diag_unicycle.py``) on the same weights: the committed
``results/mp_unicycle`` run, which the JAX tool restores from its orbax
checkpoint and the port reads from its export (``checkpoints/
mp_unicycle.npz``), over the first 12 test cases on the CPU.

The JAX tool runs as a subprocess on a copy of the run's directory (it
forces the CPU itself). Rows and summary are held field by field: the
cases, sectors and flags exactly, each number within one unit of the
rounding both tools apply (a state within 1e-4, as the collection tests
hold ORCA's LP fields, moves a rounded value by at most one unit).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.tools import diag_unicycle as diag

ROOT = Path(__file__).resolve().parents[1]
CASES = 12
# one unit of each field's rounding in both tools
UNIT = {"t_impact_s": 0.01, "bearing_deg": 0.1, "robot_speed": 1e-3,
        "heading_err_deg": 0.1, "closing_speed": 1e-3,
        "dmin_prev_step": 1e-3, "turn_saturated_frac": 1e-3,
        "seen_coming_frac": 1e-3, "stopped_at_impact_frac": 1e-3,
        "median_t_impact_s": 0.01, "median_closing_speed": 1e-3,
        "median_abs_heading_err_deg": 0.1}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A copy of ``results/mp_unicycle`` (config and checkpoint) under its
    own name, so that the port finds its export."""
    d = tmp_path_factory.mktemp("diag") / "mp_unicycle"
    d.mkdir()
    shutil.copy(ROOT / "results" / "mp_unicycle" / "config.py", d)
    shutil.copytree(ROOT / "results" / "mp_unicycle" / "rl_model_best",
                    d / "rl_model_best")
    return d


@pytest.fixture(scope="module")
def jax_diag(run_dir):
    out = run_dir.parent / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "diag_unicycle.py"),
         "--model_dir", str(run_dir), "--cases", str(CASES), "--out",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, float):
        unit = UNIT[what.rsplit(".", 1)[-1]]
        assert abs(got - want) <= unit * (1 + 1e-6), (what, got, want)
    else:  # cases, counts, sectors, flags
        assert got == want, what


def test_rows_and_summary_match_jax(run_dir, jax_diag, tmp_path):
    out = tmp_path / "torch.json"
    got = diag.main(["--model_dir", str(run_dir), "--cases", str(CASES),
                     "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == got
    assert got["summary"]["collision"] > 0  # the rows are not vacuous
    _same(got["summary"], jax_diag["summary"], "summary")
    assert len(got["collisions"]) == len(jax_diag["collisions"])
    for i, (g, w) in enumerate(zip(got["collisions"],
                                   jax_diag["collisions"])):
        _same(g, w, f"collisions[{i}]")


def test_rollout_records_and_outcomes(run_dir):
    """The rollout's records are shaped as the reference's, each step's
    state follows the last one's, and the outcomes are the JAX package's
    500-case program's (``checkpoints/mp_unicycle_test_reference.npz``)."""
    config, explorer = diag.setup(str(run_dir), torch.device("cpu"))
    rec = diag.rollout(explorer, CASES)
    steps, n = config.env.max_steps, config.env.sim.human_num
    assert rec["robots"].shape == (steps, CASES, 9)
    assert rec["humans"].shape == (steps, CASES, n, 9)
    assert rec["actions"].shape == (steps, CASES, 2)
    for k in ("dmins", "dones", "outcomes"):
        assert rec[k].shape == (steps, CASES), k
    # a case's done flag never clears, and its last outcome is the final one
    assert (np.diff(rec["dones"].astype(int), axis=0) >= 0).all()
    np.testing.assert_array_equal(rec["outcomes"][-1], rec["outcome"])
    ref = checkpoints.load_test_reference("mp_unicycle")
    np.testing.assert_array_equal(rec["outcome"], ref["outcome"][:CASES])
    with pytest.raises(ValueError):
        diag.rollout(explorer, 2, graphed=True)  # CPU tensors


def test_writes_into_the_model_dir_by_default(run_dir):
    diag.main(["--model_dir", str(run_dir), "--cases", "2", "--device",
               "cpu"])
    written = json.loads((run_dir / "diagnosis.json").read_text())
    assert written["summary"]["cases"] == 2
    assert set(written) == {"summary", "collisions"}
    (run_dir / "diagnosis.json").unlink()
