# configs/icra_benchmark/sarl.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""SARL attention baseline (parity: configs .../sarl.py)."""

from relationalgraphlearning_tpu_torch.configs.base import Config, PolicyConfig


def get_config() -> Config:
    return Config(policy=PolicyConfig(name="sarl"))
