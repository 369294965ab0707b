"""The evaluation driver's faults: the robot never moves, half of the
envs' humans left standing, the decisions altered."""

import torch

from benchmarks.tests.faults._mprl import flip_decisions


def robot_stays(mp):
    from relationalgraphlearning_tpu_torch.envs import crowd_sim
    orig = crowd_sim.propagate_full_state
    mp.setattr(crowd_sim, "propagate_full_state",
               lambda s, a, dt, k: orig(s, a * 0, dt, k))


def half_the_envs_step(mp):
    from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
    orig = CrowdSim.human_velocities

    def human_velocities(self, state):
        v = orig(self, state)
        half = v.shape[0] // 2
        return torch.cat([v[:v.shape[0] - half], 0 * v[v.shape[0] - half:]])
    mp.setattr(CrowdSim, "human_velocities", human_velocities)


FAULTS = {"state unchanged": robot_stays,
          "half the batch": half_the_envs_step,
          "answer altered": flip_decisions}
