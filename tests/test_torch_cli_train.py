"""The port's training CLI on the CPU at toy counts: it copies the config,
logs to ``output.log`` and stdout in the reference's format, honours the
flag overrides, refuses an existing directory unless ``--overwrite`` or
``--resume`` (without prompting), and resumes. And the evaluation CLI on
a port-trained checkpoint: a freshly initialised policy saved as
``rl_model_best`` evaluates 4 test cases, as ``Explorer.run_cases`` of
the same weights does."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch.cli import test as test_cli
from relationalgraphlearning_tpu_torch.cli import train as train_cli
from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import explorer as ex
from relationalgraphlearning_tpu_torch.training import trainer as tr

ROOT = Path(__file__).resolve().parents[1]
# a config file written as the repository's are, against the JAX package's
# config module (the port's loader reads it as its own)
TOY_CONFIG = '''
from relationalgraphlearning_tpu.configs.base import (
    Config, MPRLConfig, PolicyConfig, TrainConfig)


def get_config() -> Config:
    return Config(
        policy=PolicyConfig(mprl=MPRLConfig(planning_depth=2,
                                            planning_width=2)),
        train=TrainConfig(il_episodes=4, il_epochs=1, train_batches=5,
                          checkpoint_interval=4, capacity=2000))
'''
FLAGS = ["--rl_train_episodes", "6", "--evaluation_interval", "3",
         "--target_update_interval", "3", "--rl_learning_rate", "0.002",
         "--val_size", "4", "--train_envs", "4", "--collect_steps", "16",
         "--device", "cpu"]
LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d, (INFO|DEBUG): ")


def _config_file(tmp_path):
    path = tmp_path / "toy_config.py"
    path.write_text(TOY_CONFIG)
    return path


def test_cli_trains_with_the_overrides_and_logs(tmp_path, monkeypatch,
                                                capsys):
    out = tmp_path / "out"
    sizes = []
    run_cases = ex.Explorer.run_cases

    def counting(self, offset, cases, *a, **kw):
        sizes.append(len(cases))
        return run_cases(self, offset, cases, *a, **kw)

    monkeypatch.setattr(ex.Explorer, "run_cases", counting)
    result = train_cli.main(["--config", str(_config_file(tmp_path)),
                             "--output_dir", str(out), *FLAGS])
    assert result["episodes"] >= 6
    assert (out / "config.py").read_text() == TOY_CONFIG
    assert load_config_module(str(out / "config.py")).train.il_episodes == 4
    log = (out / "output.log").read_text().splitlines()
    assert log and all(LOG_LINE.match(line) for line in log)
    assert "INFO: IL demonstrations" in capsys.readouterr().out
    assert sizes and set(sizes) == {4}  # --val_size 4
    saved = ckpt.load(str(out / "rl_model"))
    assert (saved["optimizer"], saved["learning_rate"]) == ("adam", 0.002)
    val = [json.loads(line)["step"] for line in
           (out / "metrics.jsonl").read_text().splitlines()
           if "val/success_rate" in line]
    assert len(val) >= 2 and all(b // 3 > a // 3 for a, b in
                                 zip(val, val[1:]))


def test_cli_refuses_an_existing_directory_unless_asked(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    (out / "stale.txt").write_text("x")
    args = ["--config", str(_config_file(tmp_path)), "--output_dir",
            str(out), *FLAGS]
    with pytest.raises(SystemExit):
        train_cli.main(args)
    assert (out / "stale.txt").exists()
    train_cli.main(args + ["--overwrite"])
    assert not (out / "stale.txt").exists()
    assert ckpt.exists(str(out / "rl_model"))
    result = train_cli.main(args + ["--resume"])
    assert "demo_success" not in result  # resumed from rl_model
    assert "resumed RL checkpoint" in (out / "output.log").read_text()


def test_cli_module_refuses_without_prompting(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    run = subprocess.run(
        [sys.executable, "-m", "relationalgraphlearning_tpu_torch.cli.train",
         "--output_dir", str(out), "--device", "cpu"], cwd=ROOT,
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "--overwrite" in run.stderr


def test_test_cli_evaluates_a_port_checkpoint(tmp_path):
    """A freshly initialised policy saved in the port's format, no
    training: the CLI loads it (not the exported weights) and its record
    equals ``run_cases`` of the same weights on the same 4 cases."""
    model = tmp_path / "fresh"
    model.mkdir()
    (model / "config.py").write_text(TOY_CONFIG)
    config = load_config_module(str(model / "config.py"))
    policy = ModelPredictiveRLPolicy(config.policy, config.env, device="cpu")
    policy.init_params(torch.Generator().manual_seed(7))
    ckpt.save(str(model / "rl_model_best"), tr.MPRLTrainer(policy))
    assert test_cli.weights_of(str(model)) == str(model / "rl_model_best")

    record = test_cli.main(["--model_dir", str(model), "--test_size", "4",
                            "--device", "cpu"])
    assert record["cases"] == 4 and record["checkpoint"] == "rl_model_best"
    policy.eval()
    explorer = ex.Explorer(CrowdSim(config.env, device="cpu"), policy,
                           config.policy.gamma)
    want = explorer.run_cases(config.env.sim.test_seed_offset, range(4))
    assert record["success_rate"] == float(want.success_rate)
    assert record["collision_rate"] == float(want.collision_rate)
    assert record["return"] == float(want.avg_return)
    # a directory without the port's checkpoint keeps the exported weights
    assert test_cli.weights_of(str(ROOT / "results" / "mprl_td")).endswith(
        "mprl_td.npz")


def test_cli_trains_a_one_step_baseline_and_evaluates_it(tmp_path):
    """``--policy sarl``: imitation and RL with the value-only trainer at
    toy counts, then the evaluation CLI loads the port's ``rl_model_best``
    and its record equals ``run_cases`` of the same weights."""
    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)

    cfg = tmp_path / "sarl_config.py"
    cfg.write_text(TOY_CONFIG.replace(
        "policy=PolicyConfig(mprl=MPRLConfig(planning_depth=2,\n"
        "                                            planning_width=2)),",
        'policy=PolicyConfig(name="sarl"),'))
    out = tmp_path / "sarl"
    result = train_cli.main(["--policy", "sarl", "--config", str(cfg),
                             "--output_dir", str(out), *FLAGS])
    assert result["episodes"] >= 6 and result["sp_loss"] == 0.0
    saved = ckpt.load(str(out / "rl_model_best"))
    assert any(k.startswith("model.attention.") for k in saved["params"])

    record = test_cli.main(["--policy", "sarl", "--model_dir", str(out),
                            "--test_size", "4", "--device", "cpu"])
    assert record["checkpoint"] == "rl_model_best"
    config = load_config_module(str(out / "config.py"))
    policy = make_policy("sarl", config.policy, config.env, device="cpu")
    policy.networks.load_state_dict(saved["params"])
    explorer = ex.Explorer(CrowdSim(config.env, device="cpu"), policy,
                           config.policy.gamma)
    want = explorer.run_cases(config.env.sim.test_seed_offset, range(4))
    assert record["success_rate"] == float(want.success_rate)
    assert record["return"] == float(want.avg_return)
