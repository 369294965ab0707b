"""Shared set-up of the MP-RGL parity tests: the same configuration,
weights and states in the JAX package and in the PyTorch port."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu.configs import base as jbase
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.envs.scenarios import case_key
from relationalgraphlearning_tpu.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy as JPolicy)
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs import base as tbase
from relationalgraphlearning_tpu_torch.types import JointState as TJointState
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy as TPolicy)

ROOT = Path(__file__).resolve().parents[1]


def _override(cfg, mprl=None, action_space=None):
    policy = cfg.policy
    if mprl:
        policy = dataclasses.replace(policy, mprl=dataclasses.replace(
            policy.mprl, **mprl))
    if action_space:
        policy = dataclasses.replace(
            policy, action_space=dataclasses.replace(policy.action_space,
                                                     **action_space))
    return dataclasses.replace(cfg, policy=policy)


def configs(model: str, **overrides):
    """(JAX Config, port Config) of ``results/<model>/config.py``."""
    path = str(ROOT / "results" / model / "config.py")
    return (_override(jbase.load_config_module(path), **overrides),
            _override(tbase.load_config_module(path), **overrides))


def jax_policy(cfg_j, tree):
    pol = JPolicy(cfg_j.policy, cfg_j.env)
    return pol, jax.tree.map(jnp.asarray, tree)


def torch_policy(cfg_t, tree):
    return TPolicy(cfg_t.policy, cfg_t.env, device="cpu").load_flax(tree)


def policies(model: str, **overrides):
    """(JAX policy, its params, port policy) with the exported weights."""
    cfg_j, cfg_t = configs(model, **overrides)
    tree = checkpoints.load_flax_tree(model)
    pol_j, params = jax_policy(cfg_j, tree)
    return pol_j, params, torch_policy(cfg_t, tree)


def trajectory_states(cfg_j, pol_j, params, cases=8, steps=40, every=5):
    """States along the JAX policy's own test-case trajectories: (robot
    [cases·steps/every, 9], humans [..., N, 5]) as numpy."""
    env = JCrowdSim(cfg_j.env)

    def roll(i):
        s, _ = env.reset(case_key(0, cfg_j.env.sim.test_seed_offset, i))

        def body(s, _):
            js = JT.JointState(s.robot, JT.observable(s.humans))
            a = pol_j.predict(params, js, jax.random.PRNGKey(0), 0.0)
            return env.step(s, a).state, (js.robot, js.humans)

        return jax.lax.scan(body, s, None, steps)[1]

    robot, humans = jax.jit(jax.vmap(roll))(jnp.arange(cases))
    robot = np.asarray(robot)[:, ::every].reshape(-1, 9)
    humans = np.asarray(humans)[:, ::every]
    return robot, humans.reshape((-1,) + humans.shape[2:])


def to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def td_states():
    """64 states along the ``mprl_td`` policy's first 8 test trajectories
    (every 5th of 40 steps): (robot [64, 9], humans [64, N, 5])."""
    pol_j, params, _ = policies("mprl_td")
    return trajectory_states(configs("mprl_td")[0], pol_j, params)


def root_returns_reference(pol_j):
    """The reference's clipped root actions [B, W, 2], the returns predict
    ranks them by [B, W], and its chosen actions [B, 2], as one compiled
    program of (params, robot, humans) -> numpy."""

    @jax.jit
    def run(params, r, h):
        acts, rew, nr, nh = pol_j._clip_actions(params, r, h, pol_j.width)
        ret = rew + pol_j._gamma_bar(r)[..., None] * pol_j.v_planning(
            params, nr, nh, pol_j.depth)
        act = jax.vmap(lambda ri, hi: pol_j.predict(
            params, JT.JointState(ri, hi), jax.random.PRNGKey(0), 0.0))(r, h)
        return acts, ret, act

    return lambda params, robot, humans: [
        np.asarray(x) for x in run(params, jnp.asarray(robot),
                                   jnp.asarray(humans))]


def root_returns(pol_t, robot, humans):
    """The port's clipped root actions and the returns predict ranks."""
    with torch.no_grad():
        acts, rew, nr, nh = pol_t._clip_actions(robot, humans, pol_t.width)
        v_next = pol_t.v_planning(nr, nh, pol_t.depth)
        return acts, rew + pol_t._gamma_bar(robot)[..., None] * v_next


def top2_gap(values):
    top2 = np.sort(values, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def predict(pol_t, robot, humans):
    """The port's chosen actions of numpy states, as numpy."""
    js = TJointState(*to_torch(robot, humans))
    return pol_t.predict(js).numpy()


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """torch's CPU ops on two threads while this module's tests run: beside
    XLA's own thread pool (and other test workers), more threads contend
    and run the eager rollouts several times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
