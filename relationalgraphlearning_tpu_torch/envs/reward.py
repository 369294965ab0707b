"""Reward and collision logic, shared by the env step and the planner (port
of ``relationalgraphlearning_tpu/envs/reward.py``).

The reference's shaping: success +1, collision -0.25, discomfort
(dmin - 0.2)·0.5·Δt, else 0; a collision is the closest approach of the
robot and each human's relative motion segment over the step. One
implementation serves the env and the planner's estimate, so the two agree
exactly. Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig
from relationalgraphlearning_tpu_torch.geometry import (
    norm2, point_to_segment_dist, propagate_full_state)


class RewardOutput(NamedTuple):
    reward: Tensor  # [...]
    done: Tensor  # [...] bool
    outcome: Tensor  # [...] int32 (OUTCOME_*)
    dmin: Tensor  # [...] closest robot-human separation during the step


def compute_reward(robot: Tensor, humans_obs: Tensor,
                   human_velocities: Tensor, action: Tensor, t_next: Tensor,
                   cfg: EnvConfig, kinematics: Optional[str] = None
                   ) -> RewardOutput:
    """Reward for taking ``action`` [..., 2] from robot [..., 9] among humans
    [..., N, 5] that move at ``human_velocities`` [..., N, 2] this step;
    ``t_next`` [...] is the episode time after it.

    Order as in the reference's step: collision, goal, timeout, discomfort.
    ``kinematics`` overrides the env's: the action's convention follows the
    acting policy.
    """
    dt = cfg.time_step
    rc = cfg.reward

    next_robot = propagate_full_state(
        robot, action, dt, kinematics or cfg.robot_kinematics)
    robot_vel = (T.position(next_robot) - T.position(robot)) / dt

    rel_p0 = T.position(humans_obs) - T.position(robot)[..., None, :]
    rel_p1 = rel_p0 + (human_velocities - robot_vel[..., None, :]) * dt
    sep = (point_to_segment_dist(rel_p0, rel_p1, torch.zeros_like(rel_p0))
           - humans_obs[..., T.RADIUS] - robot[..., None, T.RADIUS])
    dmin = sep.amin(-1)
    collision = dmin < 0.0

    goal_dist = norm2(T.position(next_robot) - T.goal(robot))
    reaching_goal = goal_dist < robot[..., T.RADIUS]
    timeout = t_next >= cfg.time_limit

    discomfort = dmin < rc.discomfort_dist
    r_discomfort = ((dmin - rc.discomfort_dist) * rc.discomfort_penalty_factor
                    * dt)
    reward = torch.where(
        collision, rc.collision_penalty,
        torch.where(reaching_goal, rc.success_reward,
                    torch.where(discomfort, r_discomfort, 0.0)))
    done = collision | reaching_goal | timeout
    outcome = torch.full_like(dmin, T.OUTCOME_NOTHING, dtype=torch.int32)
    outcome = torch.where(timeout, T.OUTCOME_TIMEOUT, outcome)
    outcome = torch.where(reaching_goal, T.OUTCOME_REACH_GOAL, outcome)
    outcome = torch.where(collision, T.OUTCOME_COLLISION, outcome)
    return RewardOutput(reward, done, outcome, dmin)


def estimate_reward(robot: Tensor, humans_obs: Tensor, action: Tensor,
                    cfg: EnvConfig) -> RewardOutput:
    """The planner's estimate: humans keep their observed velocities, and no
    timeout applies (t_next = -inf)."""
    t_next = torch.full(robot.shape[:-1], float("-inf"), dtype=robot.dtype,
                        device=robot.device)
    return compute_reward(robot, humans_obs, T.velocity(humans_obs), action,
                          t_next, cfg)
