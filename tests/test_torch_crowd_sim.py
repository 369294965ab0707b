"""The port's batched CrowdSim against the JAX package's env vmapped over
cases: reset of 16 test cases, then 30 steps of a fixed goal-directed
action sequence, for both kinematics and for orca, socialforce, mixed and
linear humans (and a visible robot).

Each step is held on the same inputs: the port steps from the reference's
state of the step before. In float64 both packages agree to 1e-9 in every
output, so the arithmetic is the same. In float32 the robot and reward
agree at atol 1e-5 and step, done and outcome exactly; the humans' ORCA
velocities at atol 1e-4, since the LP of nearly parallel lines amplifies
float32 rounding in either implementation (3.4e-5 the most seen in one
step), and dmin, which moves along those velocities for one step, at
1e-4 · Δt. The port's own 30-step rollout, where each step feeds the
next, is held at atol 1e-3 (1.1e-4 seen after 11 steps) with done and
outcome exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import EnvConfig as JEnvConfig
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.envs import EnvState as JEnvState
from relationalgraphlearning_tpu.envs.scenarios import case_key
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim

from mprl_parity import to_torch, two_torch_threads  # noqa: F401

ATOL = 1e-5
ORCA_ATOL = 1e-4
ROLLOUT_ATOL = 1e-3
CASES, STEPS, OFFSET = 16, 30, 100_000


def _actions(kinematics):
    """A fixed action sequence [STEPS, 2] that heads for the goal (the
    robot starts at (0, -4) facing (0, 4)) with a weave."""
    t = np.arange(STEPS, dtype=np.float32)
    if kinematics == "holonomic":
        return np.stack([0.4 * np.sin(t / 3), 0.9 + 0 * t], -1).astype(
            np.float32)
    return np.stack([0.9 + 0 * t, 0.15 * np.sin(t / 4)], -1).astype(
        np.float32)


def _reference(cfg_j, actions):
    """The reference's reset states and, per step, its state after the
    step (robot, humans, step, done, outcome), reward and dmin: numpy
    [B, ...] and [T, B, ...]."""
    env = JCrowdSim(cfg_j)

    def roll(i):
        s, _ = env.reset(case_key(0, OFFSET, i))

        def body(s, a):
            out = env.step(s, a)
            return out.state, (*out.state, out.reward, out.dmin)

        return s, jax.lax.scan(body, s, jnp.asarray(actions))[1]

    s0, outs = jax.jit(jax.vmap(roll))(jnp.arange(CASES))
    return ([np.asarray(x) for x in s0],
            [np.swapaxes(np.asarray(x), 0, 1) for x in outs])


NAMES = ("robot", "humans", "step", "done", "outcome", "reward", "dmin")
EXACT = ("step", "done", "outcome")


def _compare(got, want, atol, t, orca_atol=None):
    """``orca_atol``: the humans' tolerance, and dmin's over one step."""
    for name, g, w in zip(NAMES, got, want):
        if name in EXACT:
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} at step {t}")
        else:
            tol = atol
            if orca_atol and name == "humans":
                tol = orca_atol
            if orca_atol and name == "dmin":
                tol = orca_atol * EnvConfig().time_step
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                       err_msg=f"{name} at step {t}")


def _float64_step(cfg_j):
    env = JCrowdSim(cfg_j)

    @jax.jit
    def step(state, action):
        out = jax.vmap(env.step)(JEnvState(*state), action)
        return (*out.state, out.reward, out.dmin)

    return step


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
@pytest.mark.parametrize("humans,visible", [
    ("orca", False), ("orca", True), ("socialforce", False),
    ("mixed", False), ("linear", False)])
def test_reset_and_steps_match_jax(kinematics, humans, visible):
    kw = dict(robot_kinematics=kinematics, human_policy=humans,
              robot_visible=visible)
    actions = _actions(kinematics)
    cfg_j = JEnvConfig(**kw)
    s0, want = _reference(cfg_j, actions)
    env = CrowdSim(EnvConfig(**kw), device="cpu")
    state, obs = env.reset(range(CASES), OFFSET)
    assert obs.shape == (CASES, 5, 5) and state.step.dtype == torch.int32
    _compare(state, s0, 0.0, "reset")
    EnvState = type(state)
    free = state
    with jax.enable_x64(True):
        step64 = _float64_step(cfg_j)
        for t in range(STEPS):
            prev = s0 if t == 0 else [w[t - 1] for w in want[:5]]
            a = np.broadcast_to(actions[t], (CASES, 2))
            # float32 from the reference's state
            out = env.step(EnvState(*to_torch(*prev)),
                           *to_torch(a))
            _compare((*out.state, out.reward, out.dmin),
                     [w[t] for w in want], ATOL, t, ORCA_ATOL)
            assert torch.equal(out.obs, out.state.humans[..., :5])
            # float64 from the same state
            prev64 = [x.astype(np.float64) if x.dtype == np.float32 else x
                      for x in prev]
            want64 = [np.asarray(x) for x in step64(
                [jnp.asarray(x) for x in prev64],
                jnp.asarray(a.astype(np.float64)))]
            assert want64[0].dtype == np.float64
            out = env.step(EnvState(*to_torch(*prev64)),
                           *to_torch(a.astype(np.float64)))
            _compare((*out.state, out.reward, out.dmin), want64, 1e-9, t)
            # the port's own rollout
            free_out = env.step(free, *to_torch(a))
            free = free_out.state
            _compare((*free, free_out.reward, free_out.dmin),
                     [w[t] for w in want], ROLLOUT_ATOL, t)
    if humans == "orca" and not visible:
        assert (want[4][-1] != 0).any()  # some episodes ended in 30 steps


def test_done_envs_freeze():
    env = CrowdSim(EnvConfig(), device="cpu")
    state, _ = env.reset(range(4), OFFSET)
    state = state._replace(done=torch.tensor([True, False, True, False]))
    out = env.step(state, torch.full((4, 2), 0.5))
    for name in ("robot", "humans", "step"):
        assert torch.equal(getattr(out.state, name)[0],
                           getattr(state, name)[0])
    assert out.reward[0] == 0 and out.reward[2] == 0
    assert torch.isinf(out.dmin[[0, 2]]).all()
    assert torch.isfinite(out.dmin[[1, 3]]).all()
    assert (out.state.step[[1, 3]] == 1).all()
