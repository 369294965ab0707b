"""MP-RGL on a unicycle robot in plain PyTorch: the non-holonomic action
space, the robot's propagation, the reward and the env step under it, and
the d-step planner at any width, for the benchmark's comparisons.

Written from the paper (Chen et al., "Relational Graph Learning for Crowd
Navigation", arXiv:1909.13165) and the authors' unicycle path (``ActionRot``
and the rotation branch of ``build_action_space``): an action is (v, dθ)
relative to the heading, the heading turns first and the robot then moves
along it, θ' = θ + dθ, (vx, vy) = v·(cos θ', sin θ'), p' = p + (vx, vy)·Δt.
The arithmetic follows the program's plain code where its order matters
for float32. It imports nothing of the program. What does not depend on
the robot's kinematics is ``reference/mprl.py``'s: the nets, the humans'
ORCA step (``reference/orca.py``) and the planner's V_planning; this
module gives the planner its unicycle expansion and takes its near-tie
gap directly (at w=8 the band may hold too many clip sets to try).

Departure, named: the authors' ``Agent.step`` wraps the heading, θ' mod 2π;
the JAX package and the program keep θ' unwrapped (a robot that turns past
±π reads a heading outside [0, 2π), and the value network sees that
number). This reference follows the program, so the comparison holds it to
its own semantics; a wrap would change the value network's input after
the first turn past the wrap.

State layouts as ``reference/mprl.py``'s: a robot's full state [..., 9] =
(px, py, vx, vy, radius, gx, gy, v_pref, θ); a human's observable state
[..., 5], its full state [..., 9] as the robot's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import Tensor

from benchmarks.reference import mprl
from benchmarks.reference.mprl import (
    COLLISION, GX, GY, NOT_PLANNED, NOTHING, PX, PY, RADIUS, REACH_GOAL,
    THETA, TIMEOUT, VX, VY, Reward, Step, _norm2, _segment_dist,
    human_velocities, predict_humans)


def propagate(state: Tensor, action: Tensor, dt: float) -> Tensor:
    """A unicycle full state [..., 9] moved one step at action (v, dθ):
    the heading turns, then the robot moves along it (θ not wrapped)."""
    theta = state[..., THETA] + action[..., 1]
    vx = action[..., 0] * torch.cos(theta)
    vy = action[..., 0] * torch.sin(theta)
    px = state[..., PX] + vx * dt
    py = state[..., PY] + vy * dt
    vx, vy, theta = torch.broadcast_tensors(vx, vy, theta)
    return torch.cat([torch.stack([px, py, vx, vy], -1),
                      state[..., RADIUS:THETA], theta[..., None]], -1)


def action_space(policy: Mapping, v_pref: float, device) -> Tensor:
    """Stop, then for each of the rotations linspace(−c, c) the
    exponentially spaced speeds, as (v, dθ) -> [1 + rotations·speeds, 2]."""
    a = policy["action_space"]
    speeds = [(np.exp((i + 1) / a["speed_samples"]) - 1) / (np.e - 1)
              * v_pref for i in range(a["speed_samples"])]
    c = a["rotation_constraint"]
    acts = [np.zeros(2, np.float32)]
    for rot in np.linspace(-c, c, a["rotation_samples"]):
        for s in speeds:
            acts.append(np.array([s, rot], np.float32))
    return torch.as_tensor(np.stack(acts), device=device)


def recover_actions(actions: Tensor, robot: Tensor, next_robot: Tensor,
                    dt: float) -> Tensor:
    """The action of ``actions`` [A, 2] whose propagation takes each robot
    [S, 9] exactly to its ``next_robot`` [S, 9] -> [S, 2]; NaN where none
    does (the state carries the heading and the velocity, not the
    action)."""
    A = actions.shape[0]
    moved = propagate(robot[:, None].expand(-1, A, -1),
                      actions.expand(robot.shape[0], A, 2), dt)
    hit = (moved == next_robot[:, None]).all(-1)  # [S, A]
    first = torch.argmax(hit.to(torch.int8), -1)
    return torch.where(hit.any(-1)[:, None], actions[first],
                       torch.full_like(actions[first], float("nan")))


# -------------------------------------------------------------------- reward
def reward(robot: Tensor, humans: Tensor, human_v: Tensor, action: Tensor,
           t_next: Tensor, env: Mapping) -> Reward:
    """The step's reward for a turning robot: collision over the step's
    relative motion (the robot at its new velocity along its new heading),
    goal, timeout, discomfort, in that order."""
    dt, rc = env["time_step"], env["reward"]
    nxt = propagate(robot, action, dt)
    robot_v = (nxt[..., :2] - robot[..., :2]) / dt
    rel0 = humans[..., :2] - robot[..., None, :2]
    rel1 = rel0 + (human_v - robot_v[..., None, :]) * dt
    sep = (_segment_dist(rel0, rel1, torch.zeros_like(rel0))
           - humans[..., RADIUS] - robot[..., None, RADIUS])
    dmin = sep.amin(-1)
    collision = dmin < 0.0
    goal = _norm2(nxt[..., :2] - robot[..., GX:GY + 1]) < robot[..., RADIUS]
    timeout = t_next >= env["time_limit"]
    discomfort = dmin < rc["discomfort_dist"]
    r_disc = ((dmin - rc["discomfort_dist"])
              * rc["discomfort_penalty_factor"] * dt)
    r = torch.where(collision, rc["collision_penalty"],
                    torch.where(goal, rc["success_reward"],
                                torch.where(discomfort, r_disc, 0.0)))
    outcome = torch.full_like(dmin, NOTHING, dtype=torch.int32)
    outcome = torch.where(timeout, TIMEOUT, outcome)
    outcome = torch.where(goal, REACH_GOAL, outcome)
    outcome = torch.where(collision, COLLISION, outcome)
    return Reward(r, collision | goal | timeout, outcome, dmin)


# ----------------------------------------------------------------- env step
def env_step(robot: Tensor, humans: Tensor, step: Tensor, action: Tensor,
             env: Mapping) -> Step:
    """One step of live envs: robot [B, 9], humans [B, N, 9] full states,
    ``step`` [B] the steps taken, action [B, 2] as (v, dθ) -> the next
    state."""
    dt = env["time_step"]
    hv = human_velocities(robot, humans, env)
    t_next = (step.to(torch.float32) + 1.0) * dt
    r = reward(robot, humans[..., :5], hv, action, t_next, env)
    nxt_h = torch.cat([humans[..., :2] + hv * dt, hv, humans[..., RADIUS:]],
                      -1)
    return Step(propagate(robot, action, dt), nxt_h, r.reward, r.done,
                r.outcome, r.dmin)


# ------------------------------------------------------------------ planner
class Planner(mprl.Planner):
    """``reference/mprl.py``'s planner, V_planning(s, d, w), at any width
    and depth for a unicycle robot: ŝ' the robot's turn-then-move
    propagation and the state predictor's humans, R̂ the reward of that
    motion with humans at their observed velocities and no time limit."""

    def __init__(self, config: Mapping, P: Mapping, device):
        self.env, pol = config["env"], config["policy"]
        mp = pol["mprl"]
        if not mp["do_action_clip"] or mp["sparse_search"] \
                or mp["linear_state_predictor"] or mp["canonicalize"] \
                or config["env"]["robot_kinematics"] != "unicycle":
            raise ValueError("the reference plans MP-RGL on a unicycle "
                             "robot only")
        self.P, self.gamma = P, pol["gamma"]
        self.depth, self.width = mp["planning_depth"], mp["planning_width"]
        self.actions = action_space(pol, self.env["robot_v_pref"], device)

    def expand(self, robot: Tensor, humans: Tensor):
        """Every action from every state -> (R̂ [..., A], ŝ' robot
        [..., A, 9], humans [..., A, N, 5])."""
        A = self.actions.shape[0]
        rb = robot[..., None, :].expand(robot.shape[:-1] + (A, 9))
        hb = humans[..., None, :, :].expand(humans.shape[:-2] + (A,)
                                            + humans.shape[-2:])
        acts = self.actions.expand(rb.shape[:-1] + (2,))
        t = torch.full(rb.shape[:-1], float("-inf"), device=robot.device)
        r = reward(rb, hb, hb[..., VX:VY + 1], acts, t, self.env).reward
        return r, propagate(rb, acts, self.env["time_step"]), \
            predict_humans(rb, hb, self.P)

    def gap(self, v1: Tensor, q: Tensor, acts: Tensor,
            tie: float = 1e-5) -> Tensor:
        """How far the return of each given action [S, 2] lies below the
        planner's best [S]. The root keeps the top w by v1; actions whose
        v1 lies within ``tie`` (relative) of the w-th are a near tie that
        float32 rounding may order either way, so every clip set such a
        tie allows counts, and the smallest gap over them: ``reference/
        mprl.py``'s test, one float64 band. That band may hold dozens of
        actions at w=8 (equal one-step values where the value net
        saturates), too many clip sets to try one by one, so the least is
        taken directly: the clip that holds the action and, beside the
        actions kept for sure, the near ones of the lowest returns. An
        action that no such clip keeps, or that is not one of the action
        space's, is no decision of the planner: it reads ``NOT_PLANNED``.
        """
        out = []
        match = (self.actions[None] == acts[:, None]).all(-1)  # [S, A]
        for s in range(v1.shape[0]):
            hit = torch.nonzero(match[s]).flatten()
            if hit.numel() == 0:
                out.append(NOT_PLANNED)
                continue
            a = int(hit[0])
            order = torch.sort(v1[s], descending=True,
                               stable=True).indices.tolist()
            vals = v1[s].double().tolist()
            w = self.width
            edge = vals[order[w - 1]]
            band = tie * max(1.0, abs(edge))
            near = [i for i in order if abs(vals[i] - edge) <= band]
            sure = [i for i in order[:w] if i not in near]
            if a not in sure and a not in near:
                out.append(NOT_PLANNED)
                continue
            qs = q[s].tolist()
            fill = sorted((i for i in near if i != a), key=lambda i: qs[i])
            clip = sure + ([a] if a in near else [])
            clip += fill[:w - len(clip)]
            out.append(float(q[s, clip].max() - q[s, a]))
        return torch.tensor(out, dtype=torch.float64)
