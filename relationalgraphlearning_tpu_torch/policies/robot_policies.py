"""Robot policies with no parameters: ORCA (the imitation demonstrator),
Linear and SocialForce (port of
``relationalgraphlearning_tpu/policies/robot_policies.py``).

Each ``predict`` takes the batched ``JointState`` (robot [B, 9], observable
humans [B, N, 5]) and returns holonomic actions (vx, vy) [B, 2]; like the
reference's, it ignores ``epsilon`` and draws nothing. The demonstrator
is ORCA with radii inflated by ``safety_space`` (0.15 in training,
``config.train.orca_safety_space``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, orca_velocity)
from relationalgraphlearning_tpu_torch.envs.social_force import (
    SFMParams, centralized_sfm_step)
from relationalgraphlearning_tpu_torch.geometry import norm2


def _pref_velocity(robot: Tensor) -> Tensor:
    """Toward the goal at v_pref; zero at the goal."""
    to_goal = T.goal(robot) - T.position(robot)
    d = norm2(to_goal)[..., None]
    return torch.where(d > 1e-6, to_goal / torch.clamp(d, min=1e-9), 0.0) \
        * robot[..., T.VPREF, None]


class _RobotPolicy:
    trainable = False
    kinematics = T.HOLONOMIC

    def __init__(self, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                 device="cuda"):
        del policy_cfg
        self.env_cfg = env_cfg
        self.device = torch.device(device)


class LinearPolicy(_RobotPolicy):
    """Straight to the goal at v_pref."""

    def predict(self, js: T.JointState, epsilon=0.0,
                generator: Optional[torch.Generator] = None,
                draws=None) -> Tensor:
        return _pref_velocity(js.robot)


class ORCARobotPolicy(_RobotPolicy):
    """The robot as an ORCA agent among the humans, which it sees at their
    current velocities; radii inflated by ``safety_space``."""

    def __init__(self, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                 safety_space: float = 0.0,
                 time_horizon: Optional[float] = None, device="cuda"):
        super().__init__(policy_cfg, env_cfg, device)
        self.params = ORCAParams(
            neighbor_dist=env_cfg.orca_neighbor_dist,
            time_horizon=(time_horizon if time_horizon is not None
                          else env_cfg.orca_time_horizon),
            time_step=env_cfg.time_step,
            safety_space=safety_space)

    def predict(self, js: T.JointState, epsilon=0.0,
                generator: Optional[torch.Generator] = None,
                draws=None) -> Tensor:
        robot, humans = js.robot, js.humans
        valid = torch.ones(humans.shape[:-1], dtype=torch.bool,
                           device=humans.device)
        return orca_velocity(
            T.position(robot), T.velocity(robot), robot[..., T.RADIUS],
            _pref_velocity(robot), robot[..., T.VPREF],
            T.position(humans), T.velocity(humans), humans[..., T.RADIUS],
            valid, self.params)


class SocialForceRobotPolicy(_RobotPolicy):
    """The robot driven by social forces; the humans keep their velocities
    as preferred ones, at a maximum speed of 1."""

    def __init__(self, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                 device="cuda"):
        super().__init__(policy_cfg, env_cfg, device)
        self.sfm = SFMParams()

    def predict(self, js: T.JointState, epsilon=0.0,
                generator: Optional[torch.Generator] = None,
                draws=None) -> Tensor:
        robot, humans = js.robot, js.humans
        pos = torch.cat([T.position(robot)[..., None, :],
                         T.position(humans)], -2)
        vel = torch.cat([T.velocity(robot)[..., None, :],
                         T.velocity(humans)], -2)
        rad = torch.cat([robot[..., T.RADIUS, None], humans[..., T.RADIUS]],
                        -1)
        vmax = torch.cat([robot[..., T.VPREF, None],
                          torch.ones_like(humans[..., T.RADIUS])], -1)
        pref = torch.cat([_pref_velocity(robot)[..., None, :],
                          T.velocity(humans)], -2)
        active = torch.ones(pos.shape[:-1], dtype=torch.bool,
                            device=pos.device)
        new_v = centralized_sfm_step(pos, vel, rad, pref, vmax, active,
                                     self.sfm, self.env_cfg.time_step)
        return new_v[..., 0, :]
