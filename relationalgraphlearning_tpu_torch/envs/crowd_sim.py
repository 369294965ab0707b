"""CrowdSim, batched over envs (port of ``relationalgraphlearning_tpu/envs/crowd_sim.py``).

The reference's env is a pure function of one ``EnvState`` that ``vmap``
batches; here ``reset`` and ``step`` take and return states with a leading
env dimension [B, ...]. A done env freezes: its state stays, its reward is
0 and its ``dmin`` is infinite, which a fixed-length rollout needs. The
step syncs nothing with the host and takes no data-dependent branch, so a
decision and a step can be captured as one CUDA graph.

Human crowd dynamics (centralized ORCA, social force, linear, or mixed)
run inside the step, the robot included as an obstacle iff
``robot_visible``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig
from relationalgraphlearning_tpu_torch.envs import scenarios
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, centralized_orca_step)
from relationalgraphlearning_tpu_torch.envs.reward import compute_reward
from relationalgraphlearning_tpu_torch.envs.social_force import (
    SFMParams, centralized_sfm_step)
from relationalgraphlearning_tpu_torch.geometry import (
    norm2, propagate_full_state)


class EnvState(NamedTuple):
    robot: Tensor  # [B, 9] FullState
    humans: Tensor  # [B, N, 9] FullState
    step: Tensor  # [B] int32, steps taken
    done: Tensor  # [B] bool
    outcome: Tensor  # [B] int32 OUTCOME_*


class StepOutput(NamedTuple):
    state: EnvState
    obs: Tensor  # [B, N, 5] human observable states
    reward: Tensor
    done: Tensor
    outcome: Tensor
    dmin: Tensor  # min robot-human separation this step (danger)


class CrowdSim:
    """The env's configuration and device; ``reset`` and ``step`` are pure
    functions of their tensors."""

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.orca_params = ORCAParams(
            neighbor_dist=cfg.orca_neighbor_dist,
            time_horizon=cfg.orca_time_horizon,
            time_step=cfg.time_step,
            safety_space=cfg.orca_safety_space)
        self.sfm_params = SFMParams()

    def reset(self, case_indices, phase_offset: int, base_seed: int = 0
              ) -> tuple[EnvState, Tensor]:
        """The seeded scenarios of ``case_indices`` (ints, host side) ->
        (EnvState [B], initial human observations [B, N, 5])."""
        idx = np.asarray(case_indices, np.int64).reshape(-1)
        robot, humans = scenarios.generate_cases(
            scenarios.case_key(base_seed, phase_offset, idx), self.cfg)
        B, dev = idx.shape[0], self.device
        state = EnvState(
            robot=torch.from_numpy(robot).to(dev),
            humans=torch.from_numpy(humans).to(dev),
            step=torch.zeros(B, dtype=torch.int32, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            outcome=torch.full((B,), T.OUTCOME_NOTHING, dtype=torch.int32,
                               device=dev))
        return state, T.observable(state.humans)

    def human_velocities(self, state: EnvState) -> Tensor:
        """The velocities all humans take this step [B, N, 2]."""
        cfg = self.cfg
        n = cfg.sim.human_num
        humans = state.humans

        # preferred velocity: toward the goal at v_pref; zero once reached
        to_goal = T.goal(humans) - T.position(humans)
        dist = norm2(to_goal)[..., None]
        reached = dist[..., 0] < humans[..., T.RADIUS]
        pref = torch.where(
            reached[..., None], 0.0,
            to_goal / torch.clamp(dist, min=1e-9)
            * humans[..., T.VPREF, None])
        if cfg.human_policy == "linear":
            return pref

        robot = state.robot
        if cfg.robot_visible:
            pos = torch.cat([T.position(humans), T.position(robot)[..., None,
                                                                   :]], -2)
            vel = torch.cat([T.velocity(humans), T.velocity(robot)[..., None,
                                                                   :]], -2)
            rad = torch.cat([humans[..., T.RADIUS],
                             robot[..., T.RADIUS, None]], -1)
            vpref = torch.cat([humans[..., T.VPREF],
                               robot[..., T.VPREF, None]], -1)
            prefv = torch.cat([pref, T.velocity(robot)[..., None, :]], -2)
        else:
            pos, vel = T.position(humans), T.velocity(humans)
            rad, vpref, prefv = humans[..., T.RADIUS], humans[..., T.VPREF], \
                pref
        active = torch.ones(pos.shape[:-1], dtype=torch.bool,
                            device=pos.device)

        if cfg.human_policy == "orca":  # RVO2's maxSpeed: humans at v_pref
            new_v = centralized_orca_step(pos, vel, rad, prefv, vpref, active,
                                          self.orca_params)
        elif cfg.human_policy == "socialforce":
            new_v = centralized_sfm_step(pos, vel, rad, prefv, vpref, active,
                                         self.sfm_params, cfg.time_step)
        elif cfg.human_policy == "mixed":
            # the first ceil(frac·N) humans follow ORCA, the rest social
            # force; each solver sees the whole crowd
            n_orca = math.ceil(cfg.mixed_orca_fraction * n)
            v_orca = centralized_orca_step(pos, vel, rad, prefv, vpref,
                                           active, self.orca_params)
            v_sfm = centralized_sfm_step(pos, vel, rad, prefv, vpref, active,
                                         self.sfm_params, cfg.time_step)
            is_orca = (torch.arange(pos.shape[-2], device=pos.device)
                       < n_orca)[:, None]
            new_v = torch.where(is_orca, v_orca, v_sfm)
        else:
            raise ValueError(f"unknown human policy: {cfg.human_policy}")
        return new_v[..., :n, :]

    def step(self, state: EnvState, action: Tensor,
             kinematics: Optional[str] = None) -> StepOutput:
        """Advance every env one step under the robot actions [B, 2].

        ``kinematics`` overrides the configured robot kinematics: the action
        convention follows the acting policy.
        """
        cfg = self.cfg
        kinematics = kinematics or cfg.robot_kinematics
        dt = cfg.time_step
        human_v = self.human_velocities(state)

        t_next = (state.step.to(torch.float32) + 1.0) * dt
        r = compute_reward(state.robot, T.observable(state.humans), human_v,
                           action, t_next, cfg, kinematics=kinematics)

        next_robot = propagate_full_state(state.robot, action, dt, kinematics)
        next_humans = torch.cat([T.position(state.humans) + human_v * dt,
                                 human_v, state.humans[..., T.RADIUS:]], -1)

        was_done = state.done
        new_state = EnvState(
            robot=torch.where(was_done[..., None], state.robot, next_robot),
            humans=torch.where(was_done[..., None, None], state.humans,
                               next_humans),
            step=torch.where(was_done, state.step, state.step + 1),
            done=was_done | r.done,
            outcome=torch.where(was_done, state.outcome, r.outcome))
        return StepOutput(
            state=new_state,
            obs=T.observable(new_state.humans),
            reward=torch.where(was_done, 0.0, r.reward),
            done=new_state.done,
            outcome=new_state.outcome,
            dmin=torch.where(was_done, float("inf"), r.dmin))
