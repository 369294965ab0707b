"""The port's goal-frame canonicalization against the JAX package's
``canonicalize_scene`` / ``decanonicalize_humans`` (atol 1e-5: angles from
atan2 and positions of a few metres in float32)."""

import jax.numpy as jnp
import numpy as np
import torch

from relationalgraphlearning_tpu.policies import state_transform as jst
from relationalgraphlearning_tpu_torch.policies import state_transform as tst

ATOL = 1e-5


def _scene(seed=0, B=128, n=5):
    rng = np.random.default_rng(seed)
    robot = rng.uniform(-4, 4, (B, 9)).astype(np.float32)
    robot[:8, 5:7] = robot[:8, 0:2]  # at the goal: no rotation
    humans = rng.uniform(-4, 4, (B, n, 5)).astype(np.float32)
    return robot, humans


def test_canonicalize_scene_matches_jax():
    robot, humans = _scene()
    rc_j, hc_j, rot_j = jst.canonicalize_scene(jnp.asarray(robot),
                                               jnp.asarray(humans))
    rc, hc, rot = tst.canonicalize_scene(torch.from_numpy(robot),
                                         torch.from_numpy(humans))
    for got, want in ((rc, rc_j), (hc, hc_j), (rot, rot_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    assert (rot[:8] == 0).all()


def test_decanonicalize_humans_matches_jax_and_inverts():
    robot, humans = _scene(1)
    _, hc, rot = tst.canonicalize_scene(torch.from_numpy(robot),
                                        torch.from_numpy(humans))
    back = tst.decanonicalize_humans(hc, torch.from_numpy(robot), rot)
    want = jst.decanonicalize_humans(jnp.asarray(hc.numpy()),
                                     jnp.asarray(robot),
                                     jnp.asarray(rot.numpy()))
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(back.numpy(), humans, rtol=0, atol=ATOL)
