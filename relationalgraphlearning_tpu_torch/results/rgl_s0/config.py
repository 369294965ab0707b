# configs/icra_benchmark/rgl.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""Model-free RGL one-step policy (parity: configs .../rgl.py)."""

from relationalgraphlearning_tpu_torch.configs.base import Config, PolicyConfig


def get_config() -> Config:
    return Config(policy=PolicyConfig(name="rgl"))
