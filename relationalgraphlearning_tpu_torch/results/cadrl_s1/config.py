# configs/icra_benchmark/cadrl.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""CADRL single-human baseline (parity: configs .../cadrl.py)."""

import dataclasses

from relationalgraphlearning_tpu_torch.configs.base import (
    Config, EnvConfig, PolicyConfig, SimConfig)


def get_config() -> Config:
    return Config(
        env=EnvConfig(sim=SimConfig(human_num=1)),
        policy=PolicyConfig(name="cadrl"))
