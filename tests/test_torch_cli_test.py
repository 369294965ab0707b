"""The port's evaluation CLI on 4 test cases: it prints the JAX CLI's
record (the same keys, planner overrides listed), writes it only to
``--out``, and changes no file under ``results/``. Its rates equal the
reference's per-case records of those cases."""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.cli import test as cli

ROOT = Path(__file__).resolve().parents[1]
# the keys of relationalgraphlearning_tpu/cli/test.py's record
KEYS = {"policy", "phase", "cases", "checkpoint", "human_num",
        "robot_kinematics", "git_sha", "success_rate", "collision_rate",
        "timeout_rate", "nav_time", "return", "danger_frequency",
        "avg_min_dist"}


def _results_digest():
    h = hashlib.sha256()
    for p in sorted((ROOT / "results").rglob("*")):
        if p.is_file():
            st = p.stat()
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _rates(run, n):
    outcome = checkpoints.load_test_reference(run)["outcome"][:n]
    return {"success_rate": np.mean(outcome == 1),
            "collision_rate": np.mean(outcome == 2),
            "timeout_rate": np.mean(outcome == 3)}


def test_cli_record_goes_to_out_only(tmp_path, capsys):
    before = _results_digest()
    out = tmp_path / "eval.json"
    record = cli.main(["--model_dir", "results/mprl_td", "--test_size", "4",
                       "--device", "cpu", "--out", str(out)])
    assert _results_digest() == before
    assert json.loads(out.read_text()) == record
    assert json.loads(capsys.readouterr().out) == record
    assert set(record) == KEYS
    assert record["cases"] == 4 and record["robot_kinematics"] == "holonomic"
    assert record["checkpoint"] == "rl_model_best"
    for k, v in _rates("mprl_td", 4).items():
        assert record[k] == v, k
    assert list(tmp_path.iterdir()) == [out]


def test_cli_module_with_planner_overrides(tmp_path):
    before = _results_digest()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "relationalgraphlearning_tpu_torch.cli.test",
         "--model_dir", str(ROOT / "results" / "mprl_td"),
         "--planning_depth", "1",
         "--test_size", "4", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    record = json.loads(out.stdout)
    assert record["planner_overrides"] == {"planning_depth": 1}
    assert set(record) == KEYS | {"planner_overrides"}
    for k, v in _rates("mprl_td_d1", 4).items():
        assert record[k] == v, k
    assert list(tmp_path.iterdir()) == []
    assert _results_digest() == before
