"""With the timed path broken underneath, the rest of a run comes out not
correct: a step that returns its state unchanged, half of the batch left
out (the mean over the rest), an answer altered where it is produced. Each
fault is planted in the program on the CPU at a tiny size; the one chip
of every cell leaves no exchange between chips to leave out."""

import pytest
import torch

from benchmarks import harness
from benchmarks.tests import tiny

P = "relationalgraphlearning_tpu_torch"


def _flip_decisions(mp):
    from relationalgraphlearning_tpu_torch.policies.model_predictive_rl \
        import ModelPredictiveRLPolicy
    orig = ModelPredictiveRLPolicy.predict

    def predict(self, js, *a, **kw):
        return -orig(self, js, *a, **kw)
    mp.setattr(ModelPredictiveRLPolicy, "predict", predict)


def _frozen_params(mp):
    from relationalgraphlearning_tpu_torch.training.trainer import (
        MPRLTrainer)
    mp.setattr(MPRLTrainer, "apply_grads", lambda self: None)


def _half_minibatch(mp):
    from relationalgraphlearning_tpu_torch.training import replay_buffer
    orig = replay_buffer.sample
    mp.setattr(replay_buffer, "sample",
               lambda buf, idx: orig(buf, idx[:idx.shape[0] // 2]))


def _robot_stays(mp):
    from relationalgraphlearning_tpu_torch.envs import crowd_sim
    orig = crowd_sim.propagate_full_state
    mp.setattr(crowd_sim, "propagate_full_state",
               lambda s, a, dt, k: orig(s, a * 0, dt, k))


def _half_the_envs_step(mp):
    from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
    orig = CrowdSim.human_velocities

    def human_velocities(self, state):
        v = orig(self, state)
        half = v.shape[0] // 2
        return torch.cat([v[:v.shape[0] - half], 0 * v[v.shape[0] - half:]])
    mp.setattr(CrowdSim, "human_velocities", human_velocities)


def _crowd_stays(mp):
    from relationalgraphlearning_tpu_torch.envs import mega_crowd
    mp.setattr(mega_crowd, "centralized_orca_step_knn",
               lambda pos, vel, *a, **kw: vel)


def _half_the_crowd_valued(mp):
    from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
        SparseValueNet)
    orig = SparseValueNet.forward

    def forward(self, states, *a, **kw):
        v = orig(self, states, *a, **kw)
        half = v[:v.shape[0] // 2]
        return torch.cat([half, half])
    mp.setattr(SparseValueNet, "forward", forward)


def _windows_shifted(mp):
    from relationalgraphlearning_tpu_torch.envs import mega_crowd
    orig = mega_crowd.rebuild

    def rebuild(*a, **kw):
        pos, other, cg, co, cand, em, cov = orig(*a, **kw)
        return pos, other, cg, co, torch.roll(cand, 1, -1), em, cov
    mp.setattr(mega_crowd, "rebuild", rebuild)


FAULTS = [
    ("mp_rgl.train", "state unchanged", _frozen_params),
    ("mp_rgl.train", "half the batch", _half_minibatch),
    ("mp_rgl.train", "answer altered", _flip_decisions),
    ("mp_rgl.eval500", "state unchanged", _robot_stays),
    ("mp_rgl.eval500", "half the batch", _half_the_envs_step),
    ("mp_rgl.eval500", "answer altered", _flip_decisions),
    ("mp_rgl.decide_b1", "answer altered", _flip_decisions),
    ("crowd10k.block_r8", "state unchanged", _crowd_stays),
    ("crowd10k.block_r8", "half the batch", _half_the_crowd_valued),
    ("crowd10k.block_r8", "answer altered", _windows_shifted),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
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
    _half_minibatch(monkeypatch)
    harness.run_window(driver, 0.0, harness.Observations(ctx.config,
                                                         ctx.traffic))
    driver.release()
    failed = {n for n, v, lim in driver.check() if not harness.judge(
        [(n, v, lim)])}
    assert failed & {"sweep_loss_rel", "sweep_grad_median_gap",
                     "sweep_update_median_gap"}, failed
    assert not failed & {"first_loss_rel", "first_grad_median_gap",
                         "update_median_gap"}, failed
