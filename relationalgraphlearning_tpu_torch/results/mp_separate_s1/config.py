# configs/icra_benchmark/mp_separate.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""MP-RGL with separate graph models for value and dynamics — the default
configuration (parity: crowd_nav/configs/icra_benchmark/mp_separate.py).

r5: the training recipe bakes in the measured-tightest selection settings
(VERDICT r4 #5): best-on-val checkpoint selection every 250 episodes on a
200-case val set with RL lr 5e-4 — the 0.979 ± 0.005 success band over
seeds 0–3 (PERF.md seed tables), vs 0.963 ± 0.028 for the cadence-500
variant at identical training cost. The reference's knobs keep their names
(`evaluation_interval`, `rl_learning_rate`, `val_size`); only the defaults
shipped by this config move.
"""

from relationalgraphlearning_tpu_torch.configs.base import (
    Config, EnvConfig, MPRLConfig, PolicyConfig, SimConfig, TrainConfig)


def get_config() -> Config:
    return Config(
        env=EnvConfig(sim=SimConfig(val_size=200)),
        policy=PolicyConfig(
            name="model_predictive_rl",
            mprl=MPRLConfig(planning_depth=2, planning_width=2,
                            do_action_clip=True, share_graph_model=False)),
        train=TrainConfig(rl_learning_rate=5e-4, evaluation_interval=250))
