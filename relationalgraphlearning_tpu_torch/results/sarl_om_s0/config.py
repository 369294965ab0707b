# configs/icra_benchmark/sarl_om.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""SARL with occupancy maps (parity: MultiHumanRL.build_occupancy_maps with
with_om=True, cell_num=4, cell_size=1, om_channel_size=3 — SURVEY.md §2.2)."""

from relationalgraphlearning_tpu_torch.configs.base import Config, PolicyConfig


def get_config() -> Config:
    return Config(policy=PolicyConfig(name="sarl", with_om=True))
