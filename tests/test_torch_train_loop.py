"""The port's train loop on the CPU at toy counts (4 imitation episodes,
8 RL episodes of 5 minibatches a sweep, 4 envs × 16 steps, 8 validation
cases): it writes every artifact, keeps the reference's schedule (one
sweep owed per finished episode, imitation steps sized to the filled
buffer, validation every ``evaluation_interval`` episodes), restores and
resumes from its RL or imitation checkpoint, refuses a failing
demonstrator, and refuses to capture graphs on the CPU."""

import dataclasses
import json
import logging

import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import train_loop as tl

TOY = dict(il_episodes=4, il_epochs=1, rl_train_episodes=8, train_batches=5,
           evaluation_interval=4, target_update_interval=4,
           checkpoint_interval=4, capacity=2000)
OPTS = tl.LoopOptions(train_envs=4, collect_steps=16, eval_envs=8)


def _config(**train):
    _, cfg = configs("mprl_td")
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **{**TOY, **train}),
        env=dataclasses.replace(cfg.env, sim=dataclasses.replace(
            cfg.env.sim, val_size=8)))


def _train(out, **kw):
    return tl.train(_config(), "model_predictive_rl", str(out), seed=0,
                    opts=OPTS, device="cpu", **kw)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def test_toy_run_writes_every_artifact_and_keeps_the_schedule(tmp_path):
    out = tmp_path / "run"
    art = tl.build(_config(), "model_predictive_rl", 0, "cpu")
    result = _train(out, art=art)
    for name in ("il_model", "rl_model", "rl_model_best"):
        assert ckpt.exists(str(out / name)), name
    assert result["episodes"] >= 8 and result["demo_success"] >= 0.7
    for k in ("success_rate", "collision_rate", "timeout_rate", "nav_time",
              "return", "value_loss", "sp_loss", "il_value_loss"):
        assert result[k] == result[k], k  # finite numbers, not NaN
    # one 5-minibatch sweep for each finished episode
    assert result["rl_sgd_steps"] == 5 * result["episodes"]
    # imitation: il_epochs sweeps of the filled buffer (64 transitions an
    # iteration), at least one step
    assert result["il_sgd_steps"] >= 64 // 100 + 1
    recs = _records(out)
    assert recs[0]["step"] == 0 and "il/value_loss" in recs[0]
    val = [r["step"] for r in recs if "val/success_rate" in r]
    rl = [r["step"] for r in recs if "rl/value_loss" in r]
    assert val[0] == rl[0]  # the first iteration validates
    assert all(b // 4 > a // 4 for a, b in zip(val, val[1:]))
    # the last checkpoint is the live state, and it restores in place
    saved = ckpt.load(str(out / "rl_model"))
    live = art.trainer.state_dict()
    assert saved["optimizer"] == "adam"
    for part in ("params", "target_params"):
        for k, v in live[part].items():
            assert torch.equal(saved[part][k], v), (part, k)
    params = list(art.trainer.net.parameters())
    with torch.no_grad():
        for p in params:
            p.zero_()
    ckpt.restore(str(out / "rl_model"), art.trainer)
    assert list(art.trainer.net.parameters()) == params
    assert torch.equal(params[0], saved["params"][art.trainer.names[0]])


def test_resume_from_the_rl_then_the_il_checkpoint(tmp_path, caplog):
    out = tmp_path / "run"
    _train(out)
    caplog.set_level(logging.INFO, logger=tl.__name__)
    resumed = _train(out, resume=True)
    assert "resumed RL checkpoint" in caplog.text
    assert "demo_success" not in resumed  # no imitation phase
    assert resumed["episodes"] >= 8
    caplog.clear()
    import shutil
    shutil.rmtree(out / "rl_model")
    resumed = _train(out, resume=True)
    assert "resumed IL checkpoint" in caplog.text
    assert "demo_success" not in resumed
    assert ckpt.load(str(out / "rl_model"))["optimizer"] == "adam"


def test_il_gate_aborts_on_a_failing_demonstrator(tmp_path, monkeypatch):
    class Stuck(tl.ORCARobotPolicy):
        def predict(self, js, epsilon=0.0, generator=None, draws=None):
            return torch.zeros_like(js.robot[..., :2])

    monkeypatch.setattr(tl, "ORCARobotPolicy", Stuck)
    with pytest.raises(RuntimeError, match="IL demonstrator success"):
        _train(tmp_path / "run")


def test_graphs_are_refused_on_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="CUDA"):
        tl.train(_config(), "model_predictive_rl", str(tmp_path / "run"),
                 opts=dataclasses.replace(OPTS, graphed=True), device="cpu")


def test_build_wires_the_demonstrator_and_the_trainer():
    cfg = _config(reduce_sp_update_frequency=True, optimizer="sgd")
    art = tl.build(cfg, "model_predictive_rl", 3, "cpu")
    assert art.trainer.sp_update_stride == 5
    assert art.trainer.optimizer_name == "sgd"
    assert art.demonstrator_explorer.policy.params.safety_space == 0.15
    assert art.explorer.base_seed == art.demonstrator_explorer.base_seed == 3
    assert art.explorer.kinematics == T.HOLONOMIC
