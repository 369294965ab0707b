"""LM-SARL in plain PyTorch: the goal-frame rotation, each human's local
occupancy map, the SARL value net and the one-step lookahead over the
action set, for the benchmark's comparisons.

Written from the paper (Chen, Liu, Kreiss, Alahi, "Crowd-Robot
Interaction: Crowd-aware Robot Navigation with Attention-based Deep
Reinforcement Learning", arXiv:1809.08835, §IV) and the configuration's
file. It imports nothing of the program: the weights are the flax-path
arrays of the checkpoint's ``.npz`` (``mlp1/dense_0/kernel`` [in, out],
``.../bias`` [out]), as the benchmark hands them to both sides. The reward,
the robot's motion, the action set and the env step are
``reference/mprl.py``'s.

Where this departs from the published description, it follows the
semantics the committed weights were trained with:

- The occupancy channel of a cell is the number of neighbours in it. The
  paper sums each neighbour's local state into its cell, and the authors'
  code (``MultiHumanRL.build_occupancy_maps``) marks an occupied cell 1
  (the mean of ones); the velocity channels are the mean velocity of the
  cell's neighbours in both.
- A neighbour's position and velocity are turned into the human's
  velocity frame as x·cos θ + y·sin θ, y·cos θ − x·sin θ with θ =
  atan2(vy, vx); the authors' code takes the distance and the difference
  of angles, equal in exact arithmetic. The Cartesian form and its float32
  order keep a neighbour that lies on a cell's edge in the program's cell.
- The attention is a plain softmax over the humans. The authors' code
  drops scores that are exactly 0, its padding for crowds of varying size;
  a crowd of fixed size has none.
- The one-step reward is the env's own (collision over the step's relative
  motion, then goal, then discomfort), the humans at their observed
  velocities and no time limit; the authors' code tests collision at the
  step's end positions only.

State layouts as ``reference/mprl.py``: a robot's full state [..., 9], a
human's observable state [..., 5] = (px, py, vx, vy, radius).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import Tensor

from benchmarks.reference import mprl
from benchmarks.reference.mprl import (GX, GY, NOT_PLANNED, PX, PY, RADIUS,
                                       VPREF, VX, VY)


# ------------------------------------------------------------------ rows
def rotate(robot: Tensor, humans: Tensor) -> Tensor:
    """The joint state in the frame whose x-axis points from the robot to
    its goal (the paper's robot-centric parameterization): robot [..., 9],
    humans [..., N, 5] -> rows [..., N, 13] = (d_g, v_pref, θ, r, vx, vy)
    of the robot, then (px, py, vx, vy, r_i, d_i, r + r_i) of human i.
    A holonomic robot's heading θ reads 0."""
    dx = robot[..., GX] - robot[..., PX]
    dy = robot[..., GY] - robot[..., PY]
    angle = torch.atan2(dy, dx)
    c, s = torch.cos(angle), torch.sin(angle)
    r = robot[..., RADIUS]
    own = torch.stack([torch.sqrt(dx * dx + dy * dy), robot[..., VPREF],
                       torch.zeros_like(r), r,
                       robot[..., VX] * c + robot[..., VY] * s,
                       robot[..., VY] * c - robot[..., VX] * s], -1)
    ox = humans[..., PX] - robot[..., None, PX]
    oy = humans[..., PY] - robot[..., None, PY]
    c, s = c[..., None], s[..., None]
    ri = humans[..., RADIUS]
    other = torch.stack([ox * c + oy * s, oy * c - ox * s,
                         humans[..., VX] * c + humans[..., VY] * s,
                         humans[..., VY] * c - humans[..., VX] * s,
                         ri, torch.sqrt(ox * ox + oy * oy),
                         r[..., None] + ri], -1)
    return torch.cat([own[..., None, :].expand(other.shape[:-1] + (6,)),
                      other], -1)


def occupancy_maps(humans: Tensor, cell_num: int, cell_size: float,
                   channels: int) -> Tensor:
    """Each human's grid of ``cell_num``² cells of ``cell_size`` metres
    centred on it, in its velocity frame, over the other humans, binned
    pair by pair: humans [..., N, 5] -> [..., N, cells] counts
    (``channels`` 1), else [..., N, 3·cells] of (count, mean vx, mean vy)
    cell after cell."""
    lead, n = humans.shape[:-2], humans.shape[-2]
    h = humans.reshape(-1, n, humans.shape[-1])
    m, dev = h.shape[0], h.device
    cells = cell_num * cell_num
    i, j = (t.flatten() for t in torch.meshgrid(
        torch.arange(n, device=dev), torch.arange(n, device=dev),
        indexing="ij"))
    other = i != j
    i, j = i[other], j[other]  # the (human, neighbour) pairs
    theta = torch.atan2(h[..., VY], h[..., VX])  # [M, N]; atan2(0, 0) = 0
    c, s = torch.cos(theta)[:, i], torch.sin(theta)[:, i]  # [M, P]
    dx = h[:, j, PX] - h[:, i, PX]
    dy = h[:, j, PY] - h[:, i, PY]
    x, y = dx * c + dy * s, dy * c - dx * s
    vx = h[:, j, VX] * c + h[:, j, VY] * s
    vy = h[:, j, VY] * c - h[:, j, VX] * s
    half = cell_num * cell_size / 2
    col = torch.floor((x + half) / cell_size).long()
    row = torch.floor((y + half) / cell_size).long()
    inside = (col >= 0) & (col < cell_num) & (row >= 0) & (row < cell_num)
    state = torch.arange(m, device=dev)[:, None]
    slot = ((state * n + i) * cells + row * cell_num + col)[inside]
    count = torch.zeros(m * n * cells, device=dev)
    count.index_add_(0, slot, torch.ones_like(x[inside]))
    if channels == 1:
        return count.reshape(lead + (n, cells))
    sum_vx = torch.zeros_like(count).index_add_(0, slot, vx[inside])
    sum_vy = torch.zeros_like(count).index_add_(0, slot, vy[inside])
    div = torch.clamp(count, min=1.0)
    maps = torch.stack([count, sum_vx / div, sum_vy / div], -1)
    return maps.reshape(lead + (n, 3 * cells))


# ------------------------------------------------------------------- net
def sarl_value(rows: Tensor, P: Mapping, with_global_state: bool = True
               ) -> Tensor:
    """The SARL value of rows [..., N, D] -> [...]: e_i = mlp1(row_i) (ReLU
    at its end too), h_i = mlp2(e_i), the attention's score of e_i beside
    the mean of all e (the crowd's global state), softmax over the humans,
    then mlp3 on the robot's six values and Σ softmax_i · h_i."""
    e = mprl._mlp(rows, P, "mlp1", True)
    h = mprl._mlp(e, P, "mlp2", False)
    a = e
    if with_global_state:
        a = torch.cat([e, e.mean(-2, keepdim=True).expand(e.shape)], -1)
    w = torch.softmax(mprl._mlp(a, P, "attention", False)[..., 0], -1)
    pooled = (w[..., None] * h).sum(-2)
    return mprl._mlp(torch.cat([rows[..., 0, :6], pooled], -1), P, "mlp3",
                     False)[..., 0]


# --------------------------------------------------------------- planner
class OneStep:
    """The one-step lookahead: for each action a, r(s, a) +
    γ^(Δt·v_pref)·V(s'), the robot moved by a and the humans at their
    observed velocities; the first action of the highest return."""

    def __init__(self, config: Mapping, P: Mapping, device):
        self.env, pol = config["env"], config["policy"]
        if pol["name"] != "sarl" or pol["query_env"] \
                or self.env["robot_kinematics"] != "holonomic":
            raise ValueError("the reference plans holonomic SARL with the "
                             "constant-velocity lookahead only")
        self.P, self.gamma = P, pol["gamma"]
        self.global_state = pol["sarl_with_global_state"]
        self.om = (pol["om_cell_num"], pol["om_cell_size"],
                   pol["om_channel_size"]) if pol["with_om"] else None
        self.actions = mprl.action_space(pol, self.env["robot_v_pref"],
                                         device)

    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        """V(s) [...] of robot [..., 9] and humans [..., N, 5]."""
        rows = rotate(robot, humans)
        if self.om is not None:
            rows = torch.cat([rows, occupancy_maps(humans, *self.om)], -1)
        return sarl_value(rows, self.P, self.global_state)

    @torch.no_grad()
    def returns(self, robot: Tensor, humans: Tensor) -> Tensor:
        """Every action's one-step return [S, A] from states [S]."""
        A, dt = self.actions.shape[0], self.env["time_step"]
        rb = robot[:, None, :].expand(-1, A, -1)
        hb = humans[:, None].expand(-1, A, -1, -1)
        acts = self.actions.expand(rb.shape[:-1] + (2,))
        t = torch.full(rb.shape[:-1], float("-inf"), device=robot.device)
        r = mprl.reward(rb, hb, hb[..., VX:VY + 1], acts, t, self.env).reward
        nh = torch.cat([hb[..., :2] + hb[..., VX:VY + 1] * dt, hb[..., VX:]],
                       -1)
        v = self.value(mprl.propagate(rb, acts, dt), nh)
        return r + torch.pow(self.gamma, dt * robot[:, None, VPREF]) * v

    @torch.no_grad()
    def decide(self, robot: Tensor, humans: Tensor, block: int = 128):
        """The chosen actions [S, 2] and the returns [S, A], in blocks of
        ``block`` states."""
        q = torch.cat([self.returns(robot[k:k + block], humans[k:k + block])
                       for k in range(0, robot.shape[0], block)])
        return self.actions[torch.argmax(q, -1)], q

    def gap(self, q: Tensor, acts: Tensor, tie: float = 1e-5) -> Tensor:
        """How far the return of each given action [S, 2] lies below the
        best [S], in float64. A gap within ``tie`` of the best (relative,
        at least 1e-5 absolute) is a near tie that float32 may order either
        way and reads 0; an action that is not one of the set reads
        ``NOT_PLANNED``."""
        match = (self.actions[None] == acts[:, None]).all(-1)  # [S, A]
        found = match.any(-1)
        q = q.double()
        best = q.amax(-1)
        gap = best - (q * match).sum(-1)
        gap = torch.where(gap <= tie * best.abs().clamp(min=1.0), 0.0, gap)
        return torch.where(found, gap, NOT_PLANNED).cpu()
