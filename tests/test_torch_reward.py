"""The port's reward and collision logic against the JAX package's
``envs/reward.py`` (atol 1e-6 on rewards and dmin; done and outcome
exact), on seeded states that collide, reach the goal, time out and come
within the discomfort distance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import EnvConfig as JEnvConfig
from relationalgraphlearning_tpu.envs import reward as jr
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig
from relationalgraphlearning_tpu_torch.envs import reward as tr

ATOL = 1e-6


def _scenes(seed, B=512, n=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    robot = np.zeros((B, 9), f32)
    robot[:, :2] = rng.uniform(-2, 2, (B, 2))
    robot[:, 2:4] = rng.uniform(-1, 1, (B, 2))
    robot[:, 4] = 0.3
    robot[:, 5:7] = robot[:, :2] + rng.uniform(-0.6, 0.6, (B, 2))
    robot[:, 7] = 1.0
    robot[:, 8] = rng.uniform(-np.pi, np.pi, B)
    humans = np.zeros((B, n, 5), f32)
    humans[..., :2] = robot[:, None, :2] + rng.uniform(-2.5, 2.5, (B, n, 2))
    humans[..., 2:4] = rng.uniform(-1, 1, (B, n, 2))
    humans[..., 4] = 0.3
    vel = rng.uniform(-1, 1, (B, n, 2)).astype(f32)
    action = rng.uniform(-1, 1, (B, 2)).astype(f32)
    t_next = rng.choice([0.25, 12.5, 25.0, 30.0], B).astype(f32)
    return robot, humans, vel, action, t_next


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_compute_reward_matches_jax(kinematics):
    arrs = _scenes(0)
    want = jr.compute_reward(*map(jnp.asarray, arrs), JEnvConfig(),
                             kinematics=kinematics)
    got = tr.compute_reward(*map(torch.from_numpy, arrs), EnvConfig(),
                            kinematics=kinematics)
    for name in ("reward", "dmin"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    for name in ("done", "outcome"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.outcome.dtype == torch.int32
    # every branch is taken
    assert set(np.unique(got.outcome.numpy())) == {0, 1, 2, 3}
    r = got.reward.numpy()
    assert ((r < 0) & (r > -0.25)).any()  # discomfort


def test_estimate_reward_matches_jax():
    robot, humans, _, action, _ = _scenes(1)
    A = 81
    act = np.random.default_rng(2).uniform(-1, 1, (A, 2)).astype(np.float32)
    rb = np.broadcast_to(robot[:, None], (512, A, 9))
    hb = np.broadcast_to(humans[:, None], (512, A, 5, 5))
    ab = np.broadcast_to(act, (512, A, 2))
    want = jr.estimate_reward(jnp.asarray(rb), jnp.asarray(hb),
                              jnp.asarray(ab), JEnvConfig())
    got = tr.estimate_reward(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in (rb, hb, ab)), EnvConfig())
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.outcome.numpy(),
                                  np.asarray(want.outcome))
    assert not (got.outcome.numpy() == 3).any()  # no timeout in the estimate
