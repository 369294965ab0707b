# configs/icra_benchmark/mp_unicycle_anneal.py as cli/train.py copied it for
# this run's stage 2 (stage 1, in the same directory: configs/icra_benchmark/
# mp_unicycle.py --rl_train_episodes 14000 --evaluation_interval 250
# --val_size 200 --randomseed 0; output.log holds both), its one import
# pointed at the port's config module.
"""MP-RGL unicycle, annealed rotation constraint — stage 2 (VERDICT r4 #6).

The r4 diagnosis (results/mp_unicycle/diagnosis.json): the π/4-trained
checkpoint's 13% collisions are head-on, turn-saturated squeezes; relaxing
the constraint to π/3 and widening the tree to w=8 AT EVAL time reached
0.938 — but that row rides eval-time re-shaping. The native π/3-from-
scratch retrain was a negative result (0.858 — wide turns wreck early
exploration; mp_unicycle_rc3.py).

This config is the training-side lever between those two points: an
ANNEAL. Stage 1 is the committed 20k-episode π/4 w=2 run
(results/mp_unicycle); stage 2 (this file) resumes its checkpoint and
fine-tunes 6k episodes with the action space already widened to π/3 and
the planner at the w=8 the final policy will use — exploration happened
under the tight constraint, adaptation happens under the deployed one.
Exploration stays at the post-decay ε=0.1 throughout (epsilon_start ==
epsilon_end; a resumed run restarts the decay clock, so stage 2 must pin
it). The resulting model row evaluates at ITS OWN config — no re-shaping.

Run:
    mkdir -p data/mp_unicycle_anneal
    cp -r results/mp_unicycle/rl_model_best data/mp_unicycle_anneal/rl_model
    tools/train_eval.sh mp_unicycle_anneal \
        configs/icra_benchmark/mp_unicycle_anneal.py --resume
"""

import math

from relationalgraphlearning_tpu_torch.configs.base import (
    ActionSpaceConfig, Config, EnvConfig, MPRLConfig, PolicyConfig,
    SimConfig, TrainConfig)


def get_config() -> Config:
    return Config(
        env=EnvConfig(robot_kinematics="unicycle",
                      sim=SimConfig(val_size=200)),
        policy=PolicyConfig(
            name="model_predictive_rl",
            action_space=ActionSpaceConfig(
                rotation_constraint=math.pi / 3),
            mprl=MPRLConfig(planning_depth=2, planning_width=8,
                            do_action_clip=True)),
        train=TrainConfig(rl_train_episodes=6000,
                          rl_learning_rate=5e-4,
                          evaluation_interval=250,
                          epsilon_start=0.1, epsilon_end=0.1))
