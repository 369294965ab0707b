# configs/icra_benchmark/mp_w4.py as cli/train.py copied it for this
# run, its one import pointed at the port's config module.
"""MP-RGL d=2 trained WITH planning_width=4 (the r2 ablation showed test-time
w=4 on a w=2-trained checkpoint already gains nav time — 0.980/11.41 s vs
0.984/11.57 s; training under the same planner closes the train/test planner
mismatch). Parity: ModelPredictiveRL planning_width config (SURVEY.md §2.2).
"""

from relationalgraphlearning_tpu_torch.configs.base import (
    Config, EnvConfig, MPRLConfig, PolicyConfig, SimConfig, TrainConfig)


def get_config() -> Config:
    return Config(
        env=EnvConfig(sim=SimConfig(val_size=200)),
        policy=PolicyConfig(
            name="model_predictive_rl",
            mprl=MPRLConfig(planning_depth=2, planning_width=4,
                            do_action_clip=True)),
        # r5 selection recipe (see mp_separate.py): tight cadence-250 band
        train=TrainConfig(rl_learning_rate=5e-4, evaluation_interval=250))
