"""The port's geometry against the JAX package's ``geometry.py`` on seeded
float32 inputs (atol 1e-6; angles wrap, so the unicycle conversion is also
checked away from ±π)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu import geometry as jg
from relationalgraphlearning_tpu_torch import geometry as tg

ATOL = 1e-6


def _rng_arrays(seed, *shapes, scale=4.0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, s) * scale).astype(np.float32)
            for s in shapes]


def test_point_to_segment_dist():
    p1, p2, q = _rng_arrays(0, (256, 2), (256, 2), (256, 2))
    p2[:16] = p1[:16]  # degenerate segments
    got = tg.point_to_segment_dist(*map(torch.from_numpy, (p1, p2, q)))
    want = jg.point_to_segment_dist(*map(jnp.asarray, (p1, p2, q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_propagate_full_state(kinematics):
    state, action = _rng_arrays(1, (8, 5, 9), (8, 5, 2), scale=1.0)
    got = tg.propagate_full_state(torch.from_numpy(state),
                                  torch.from_numpy(action), 0.25, kinematics)
    want = jg.propagate_full_state(jnp.asarray(state), jnp.asarray(action),
                                   0.25, kinematics)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError):
        tg.propagate_full_state(torch.from_numpy(state),
                                torch.from_numpy(action), 0.25, "hover")


def test_reached_destination():
    (state,) = _rng_arrays(2, (512, 9), scale=1.0)
    state[:, 4] = 0.5
    for tol in (None, 0.8):
        got = tg.reached_destination(
            torch.from_numpy(state),
            None if tol is None else torch.tensor(tol))
        want = jg.reached_destination(jnp.asarray(state), tol)
        assert got.numpy().any() and not got.numpy().all()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("constraint", [np.pi / 4, np.pi / 3])
def test_holonomic_to_unicycle(constraint):
    action, theta = _rng_arrays(3, (512, 2), (512,), scale=1.0)
    theta = theta * 3.0
    action[:8] = 0.0  # standing still keeps the heading
    got = tg.holonomic_to_unicycle(torch.from_numpy(action),
                                   torch.from_numpy(theta), constraint)
    want = jg.holonomic_to_unicycle(jnp.asarray(action), jnp.asarray(theta),
                                    constraint)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert (got[:8] == 0).all()
