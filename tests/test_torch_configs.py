"""The port's config dataclasses equal the JAX package's, field by field."""

import dataclasses

import pytest

from relationalgraphlearning_tpu.configs import base as jax_base
from relationalgraphlearning_tpu_torch.configs import base as torch_base

NAMES = ["RewardConfig", "SimConfig", "EnvConfig", "GCNConfig",
         "ActionSpaceConfig", "MPRLConfig", "PolicyConfig", "TrainConfig",
         "Config"]


@pytest.mark.parametrize("name", NAMES)
def test_dataclass_defaults_equal(name):
    ref = getattr(jax_base, name)()
    port = getattr(torch_base, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])


def test_every_dataclass_is_covered():
    ref = {k for k, v in vars(jax_base).items()
           if dataclasses.is_dataclass(v) and isinstance(v, type)}
    assert ref == set(NAMES)


def test_replace_and_max_steps():
    cfg = torch_base.replace(torch_base.EnvConfig(), time_limit=10.0)
    assert cfg.max_steps == jax_base.replace(
        jax_base.EnvConfig(), time_limit=10.0).max_steps == 40
