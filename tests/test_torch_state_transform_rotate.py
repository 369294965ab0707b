"""The port's ``rotate_joint_state`` and ``build_occupancy_maps`` against
the JAX package's, on the same seeded numpy scenes: rtol 1e-5 / atol 1e-6
(float32 rotations of positions of a few metres); occupancy counts exact,
including humans exactly on a cell edge, standing humans (atan2(0, 0) = 0)
and ``om_channel_size`` 1 and 3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.policies import state_transform as jst
from relationalgraphlearning_tpu_torch.policies import state_transform as tst

TOL = dict(rtol=1e-5, atol=1e-6)


def _scene(seed=0, B=256, n=5):
    rng = np.random.default_rng(seed)
    robot = rng.uniform(-4, 4, (B, 9)).astype(np.float32)
    robot[:, 4] = rng.uniform(0.2, 0.4, B)
    robot[:, 8] = rng.uniform(-np.pi, np.pi, B)
    humans = rng.uniform(-4, 4, (B, n, 5)).astype(np.float32)
    humans[..., 2:4] = rng.uniform(-1, 1, (B, n, 2))
    humans[..., 4] = rng.uniform(0.2, 0.4, (B, n))
    return robot, humans


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_rotate_joint_state_matches_jax(kinematics):
    robot, humans = _scene()
    want = np.asarray(jst.rotate_joint_state(
        jnp.asarray(robot), jnp.asarray(humans), kinematics))
    got = tst.rotate_joint_state(torch.from_numpy(robot),
                                 torch.from_numpy(humans), kinematics)
    assert got.shape == (256, 5, 13) and tst.ROTATED_ROBOT_DIM == 6 \
        and tst.ROTATED_HUMAN_DIM == 7
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if kinematics == "holonomic":
        assert (got[..., 2] == 0).all()


def _edge_scene():
    """Humans on cell edges (integer offsets in a human's own frame, with a
    cell size of 1), standing humans, and some far outside every grid."""
    robot, humans = _scene(1, B=64, n=6)
    humans[:16, :, 2:4] = 0.0  # standing: the frame is the world's
    # human 0 at the origin, the others at whole-metre offsets: on edges
    humans[:16, :, 0] = np.array([0.0, 1.0, -2.0, 0.0, 2.0, 7.0])
    humans[:16, :, 1] = np.array([0.0, 0.0, 1.0, -1.0, -2.0, 0.0])
    # moving along x: the frame is the world's, edges stay edges
    humans[16:24, :, 2] = 1.0
    humans[16:24, :, 3] = 0.0
    humans[16:24, :, 0] = np.array([0.5, 1.5, -0.5, 0.5, 2.5, 0.5])
    humans[16:24, :, 1] = np.array([0.0, 0.0, 1.0, -2.0, 0.0, 2.0])
    return robot, humans


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scene", ["random", "edges"])
def test_occupancy_maps_match_jax(channels, scene):
    _, humans = _scene(2) if scene == "random" else _edge_scene()
    want = np.asarray(jst.build_occupancy_maps(jnp.asarray(humans), 4, 1.0,
                                               channels))
    got = tst.build_occupancy_maps(torch.from_numpy(humans), 4, 1.0,
                                   channels).numpy()
    n = humans.shape[-2]
    assert got.shape == want.shape == humans.shape[:-1] + (16 * channels,)
    occ_g, occ_w = got[..., ::channels], want[..., ::channels]
    np.testing.assert_array_equal(occ_g, occ_w)  # counts exactly
    assert occ_g.sum() > 0 and occ_g.max() <= n - 1
    np.testing.assert_allclose(got, want, **TOL)


def test_occupancy_edges_fall_as_floor_puts_them():
    """A human 1 m ahead of a standing human lands in cell (x=3, y=2) of the
    4 x 4 grid (floor((1 + 2)/1) = 3): the cell index is yi·4 + xi."""
    humans = np.zeros((1, 2, 5), np.float32)
    humans[0, 1, 0] = 1.0
    got = tst.build_occupancy_maps(torch.from_numpy(humans), 4, 1.0, 1)
    want = np.asarray(jst.build_occupancy_maps(jnp.asarray(humans), 4, 1.0,
                                               1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 2 * 4 + 3] == 1 and got[0, 0].sum() == 1
    assert got[0, 1, 2 * 4 + 1] == 1 and got[0, 1].sum() == 1
