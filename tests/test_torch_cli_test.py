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
import pytest

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


def _rates(run, n, outcome=None):
    if outcome is None:
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


# Test case 0 of orca_th10 is an exact float32 tie in the reference itself:
# the ORCA robot (safety space 0) steers tangent to a human's disc, and at
# step 91 the JAX package's 500-case program measures a closest approach of
# 0.0 m (no collision; the case times out) while its one-case program
# measures -6e-8 m (a collision); the port on the CPU, -6e-8 m too. Either
# of the reference's outcomes is accepted there, nowhere else.
TIES = {"orca_th10": {0: (2, 3)}}

BASELINES = {  # run -> the CLI's arguments
    "sarl": ["--policy", "sarl", "--model_dir", "results/sarl"],
    "sarl_om": ["--policy", "sarl", "--model_dir", "results/sarl_om"],
    "lstm_rl": ["--policy", "lstm_rl", "--model_dir", "results/lstm_rl"],
    "cadrl": ["--policy", "cadrl", "--model_dir", "results/cadrl",
              "--human_num", "5"],
    "rgl": ["--policy", "rgl", "--model_dir", "results/rgl"],
    "orca": ["--policy", "orca", "--model_dir", "results/orca"],
    "orca_th10": ["--policy", "orca", "--model_dir", "results/orca_th10",
                  "--orca_time_horizon", "10"],
}


@pytest.mark.parametrize("run", list(BASELINES))
def test_cli_baseline_matches_the_jax_per_case_record(run, tmp_path, capsys):
    """4 test cases of each baseline row of the paper's table: the record's
    rates equal the JAX package's per-case records of those cases, the
    record names the checkpoint as the JAX CLI does, and a directory
    ``--out`` gets the JAX CLI's file name."""
    before = _results_digest()
    record = cli.main(BASELINES[run] + ["--test_size", "4", "--device", "cpu",
                                        "--out", str(tmp_path)])
    capsys.readouterr()
    assert _results_digest() == before
    trained = record["policy"] != "orca"
    assert record["checkpoint"] == ("rl_model_best" if trained
                                    else "none (untrained policy)")
    assert record["human_num"] == 5
    extra = {"orca_time_horizon"} if run == "orca_th10" else set()
    assert set(record) == KEYS | extra
    name = "eval_test_th10.json" if run == "orca_th10" else "eval_test.json"
    assert [p.name for p in tmp_path.iterdir()] == [name]
    assert json.loads((tmp_path / name).read_text()) == record
    ref = checkpoints.load_test_reference(run)["outcome"][:4]
    allowed = [ref]
    for case, outcomes in TIES.get(run, {}).items():
        allowed = [np.where(np.arange(4) == case, o, ref) for o in outcomes]
    assert any(all(record[k] == v for k, v in _rates(run, 4, o).items())
               for o in allowed), (record, allowed)


@pytest.mark.parametrize("flag,value", [("--safety_space", "0.1"),
                                        ("--orca_time_horizon", "10")])
def test_cli_orca_flags_only_apply_to_orca(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--policy", "sarl", "--model_dir", "results/sarl", flag,
                  value, "--device", "cpu", "--test_size", "1"])
    assert e.value.code == 2
    assert "only applies to --policy orca" in capsys.readouterr().err
