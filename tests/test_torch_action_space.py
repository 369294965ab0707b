"""The port's action space and sparse-search buckets equal the JAX
package's arrays exactly, for both kinematics and other sample counts."""

import numpy as np
import pytest

from relationalgraphlearning_tpu.configs.base import (
    ActionSpaceConfig as JASC)
from relationalgraphlearning_tpu.policies import action_space as jas
from relationalgraphlearning_tpu_torch.configs.base import ActionSpaceConfig
from relationalgraphlearning_tpu_torch.policies import action_space as tas


@pytest.mark.parametrize("kw", [{}, dict(rotation_constraint=np.pi / 3),
                                dict(speed_samples=3, rotation_samples=24)])
@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_action_space_equal(kinematics, kw):
    got = tas.build_action_space(ActionSpaceConfig(**kw), 1.0, kinematics)
    want = jas.build_action_space(JASC(**kw), 1.0, kinematics)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("speed,rot", [(2, 8), (5, 16), (1, 4)])
def test_group_index_equal(speed, rot):
    np.testing.assert_array_equal(
        tas.build_action_group_index(ActionSpaceConfig(), speed, rot),
        jas.build_action_group_index(JASC(), speed, rot))
