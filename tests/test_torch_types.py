"""The port's state layouts, accessors and outcome codes against the JAX
package's ``types.py`` (float32, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu_torch import types as TT

ATOL = 1e-6


def test_layout_and_codes_equal():
    for name in ("PX", "PY", "VX", "VY", "RADIUS", "GX", "GY", "VPREF",
                 "THETA", "FULL_STATE_DIM", "OBSERVABLE_STATE_DIM",
                 "HOLONOMIC", "UNICYCLE", "OUTCOME_NOTHING",
                 "OUTCOME_REACH_GOAL", "OUTCOME_COLLISION",
                 "OUTCOME_TIMEOUT"):
        assert getattr(TT, name) == getattr(JT, name), name
    assert TT.JointState._fields == JT.JointState._fields


def test_accessors_match():
    s = np.random.default_rng(0).normal(size=(4, 3, 9)).astype(np.float32)
    for fn in ("observable", "position", "velocity", "goal", "radius"):
        np.testing.assert_allclose(
            getattr(TT, fn)(torch.from_numpy(s)).numpy(),
            np.asarray(getattr(JT, fn)(jnp.asarray(s))), rtol=0, atol=ATOL)


def test_constructors_match():
    rng = np.random.default_rng(1)
    cols = [rng.normal(size=5).astype(np.float32) for _ in range(9)]
    got = TT.full_state(*(torch.from_numpy(c) for c in cols))
    want = JT.full_state(*(jnp.asarray(c) for c in cols))
    assert got.dtype == torch.float32 and got.shape == (5, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # scalars broadcast against arrays, as the reference's stack does
    np.testing.assert_allclose(
        TT.full_state(0.0, -4.0, 0, 0, 0.3, 0, 4.0, 1.0, np.pi / 2).numpy(),
        np.asarray(JT.full_state(0.0, -4.0, 0, 0, 0.3, 0, 4.0, 1.0,
                                 jnp.pi / 2)), rtol=0, atol=ATOL)
