# configs/icra_benchmark/lstm_rl.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""LSTM-RL baseline (parity: configs .../lstm_rl.py)."""

from relationalgraphlearning_tpu_torch.configs.base import Config, PolicyConfig


def get_config() -> Config:
    return Config(policy=PolicyConfig(name="lstm_rl"))
