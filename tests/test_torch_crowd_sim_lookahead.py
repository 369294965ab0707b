"""The port's privileged one-step lookahead (``CrowdSim.lookahead_actions``,
batched over envs) against the JAX package's, vmapped over the same envs,
over the 81-action holonomic space and the unicycle one, from the
reference's own states along 16 test cases: rewards [B, A], next robot
states [B, A, 9] and next human observations [B, N, 5].

Tolerances: atol 1e-5 with linear humans; with ORCA humans the human
velocities (and so the next observations and the discomfort reward that
moves along them) at atol 1e-4, the bound ``test_torch_crowd_sim.py``
states for ORCA's float32 LP. ``onestep_lookahead`` is ``step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import EnvConfig as JEnvConfig
from relationalgraphlearning_tpu.configs.base import PolicyConfig
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.envs import EnvState as JEnvState
from relationalgraphlearning_tpu.envs.scenarios import case_key
from relationalgraphlearning_tpu.policies.action_space import (
    build_action_space)
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig
from relationalgraphlearning_tpu_torch.envs.crowd_sim import (
    CrowdSim, EnvState)

from mprl_parity import to_torch, two_torch_threads  # noqa: F401

ATOL, ORCA_ATOL = 1e-5, 1e-4
CASES, OFFSET = 16, 100_000


def _states(cfg_j, steps=(0, 6, 14)):
    """The reference's states [len(steps)·CASES] after goal-directed steps,
    as numpy (robot, humans, step, done, outcome)."""
    env = JCrowdSim(cfg_j)

    def roll(i):
        s, _ = env.reset(case_key(0, OFFSET, i))
        a = jnp.asarray([0.1, 0.9] if cfg_j.robot_kinematics == "holonomic"
                        else [0.9, 0.05])

        def body(s, _):
            return env.step(s, a).state, s

        return jax.lax.scan(body, s, None, max(steps) + 1)[1]

    traj = jax.jit(jax.vmap(roll))(jnp.arange(CASES))
    return [np.asarray(x)[:, list(steps)].reshape(
        (-1,) + x.shape[2:]) for x in traj]


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
@pytest.mark.parametrize("humans", ["orca", "linear"])
def test_lookahead_actions_match_jax(kinematics, humans):
    kw = dict(robot_kinematics=kinematics, human_policy=humans)
    cfg_j = JEnvConfig(**kw)
    states = _states(cfg_j)
    actions = build_action_space(PolicyConfig().action_space,
                                 cfg_j.robot_v_pref, kinematics)
    env_j = JCrowdSim(cfg_j)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda s: env_j.lookahead_actions(s, jnp.asarray(actions))))(
            JEnvState(*[jnp.asarray(x) for x in states]))]
    env = CrowdSim(EnvConfig(**kw), device="cpu")
    got = env.lookahead_actions(EnvState(*to_torch(*states)),
                                torch.from_numpy(np.asarray(actions)))
    B, A = states[0].shape[0], actions.shape[0]
    assert A == 81
    assert [tuple(g.shape) for g in got] == [(B, A), (B, A, 9), (B, 5, 5)]
    tol = ORCA_ATOL if humans == "orca" else ATOL
    for name, g, w, t in zip(("reward", "next_robot", "next_obs"), got, want,
                             (tol, ATOL, tol)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=t,
                                   err_msg=name)


def test_onestep_lookahead_is_the_step():
    env = CrowdSim(EnvConfig(), device="cpu")
    state, _ = env.reset(range(8), OFFSET)
    a = torch.full((8, 2), 0.5)
    ahead, step = env.onestep_lookahead(state, a), env.step(state, a)
    for x, y in zip(ahead.state, step.state):
        assert torch.equal(x, y)
    assert torch.equal(ahead.reward, step.reward)


def test_lookahead_reward_is_the_steps_reward():
    """Each action's lookahead reward and next robot state are those of the
    env's step under that action (the port's own step)."""
    env = CrowdSim(EnvConfig(), device="cpu")
    state, _ = env.reset(range(8), OFFSET)
    actions = torch.from_numpy(np.asarray(build_action_space(
        PolicyConfig().action_space, 1.0, "holonomic")))
    rew, next_robot, next_obs = env.lookahead_actions(state, actions)
    for k in (0, 17, 80):
        out = env.step(state, actions[k].expand(8, 2))
        torch.testing.assert_close(rew[:, k], out.reward, rtol=0, atol=1e-6)
        torch.testing.assert_close(next_robot[:, k], out.state.robot,
                                   rtol=0, atol=0)
        torch.testing.assert_close(next_obs, out.obs, rtol=0, atol=1e-6)
