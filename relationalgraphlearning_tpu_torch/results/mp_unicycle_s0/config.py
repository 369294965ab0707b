# configs/icra_benchmark/mp_unicycle.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""MP-RGL with unicycle kinematics (ActionRot) — exercises the reference's
``kinematics='unicycle'`` + ``rotation_constraint`` path end to end
(parity: Agent kinematics + CADRL.build_action_space rotation branch,
SURVEY.md §2.1/§2.2)."""

from relationalgraphlearning_tpu_torch.configs.base import (
    Config, EnvConfig, MPRLConfig, PolicyConfig)


def get_config() -> Config:
    return Config(
        env=EnvConfig(robot_kinematics="unicycle"),
        policy=PolicyConfig(
            name="model_predictive_rl",
            # canonicalize=True was tried in r3 and made things WORSE
            # (IL val 0.38 vs 0.50 raw; RL collapsed to 0.00) — the
            # capability stays (invariance-tested, models/mprl_networks.py)
            # but the benchmark row trains on raw coordinates.
            mprl=MPRLConfig(planning_depth=2, planning_width=2,
                            do_action_clip=True)))
