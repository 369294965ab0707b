"""MP-RGL in plain PyTorch: the crowd env's step, the RGL nets, the d-step
planner and one training step, for the benchmark's comparisons.

Written from the paper's equations (Chen et al., "Relational Graph Learning
for Crowd Navigation", arXiv:1909.13165) and the configuration's file, with
the arithmetic of the program's plain code where its order matters for
float32 (the env step, the reward and ORCA are frozen copies). It imports
nothing of the program: the weights are the flax-path arrays of the
checkpoint's ``.npz`` (``kernel`` [in, out], ``bias`` [out]), as the
benchmark hands them to both sides.

State layouts: a robot's full state [..., 9] = (px, py, vx, vy, radius,
gx, gy, v_pref, theta); a human's observable state [..., 5] = (px, py,
vx, vy, radius), its full state [..., 9] as the robot's.
"""

from __future__ import annotations

import itertools
import math
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import Tensor

from benchmarks.reference.orca import ORCAParams, centralized_orca_step

PX, PY, VX, VY, RADIUS, GX, GY, VPREF, THETA = range(9)
NOTHING, REACH_GOAL, COLLISION, TIMEOUT = range(4)
# the gap of an action the planner could not have chosen (returns are
# O(0.1)-O(1); a float32 near tie reads ~1e-7)
NOT_PLANNED = 1.0


# ------------------------------------------------------------------ geometry
def _norm2(v: Tensor) -> Tensor:
    return torch.sqrt((v * v).sum(-1))


def _segment_dist(p1: Tensor, p2: Tensor, q: Tensor) -> Tensor:
    seg = p2 - p1
    seg_sq = (seg * seg).sum(-1, keepdim=True)
    t = ((q - p1) * seg).sum(-1, keepdim=True) / torch.clamp(seg_sq,
                                                             min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return _norm2(q - (p1 + t * seg))


def propagate(state: Tensor, action: Tensor, dt: float) -> Tensor:
    """A holonomic full state [..., 9] moved one step at action (vx, vy)."""
    vx, vy = action[..., 0], action[..., 1]
    theta = state[..., THETA]
    px = state[..., PX] + vx * dt
    py = state[..., PY] + vy * dt
    vx, vy, theta = torch.broadcast_tensors(vx, vy, theta)
    return torch.cat([torch.stack([px, py, vx, vy], -1),
                      state[..., RADIUS:THETA], theta[..., None]], -1)


# -------------------------------------------------------------------- reward
class Reward(NamedTuple):
    reward: Tensor
    done: Tensor
    outcome: Tensor
    dmin: Tensor


def reward(robot: Tensor, humans: Tensor, human_v: Tensor, action: Tensor,
           t_next: Tensor, env: Mapping) -> Reward:
    """The step's reward: collision over the step's relative motion, goal,
    timeout, discomfort, in that order (the paper's shaping)."""
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
def orca_params(env: Mapping) -> ORCAParams:
    return ORCAParams(env["orca_neighbor_dist"], env["orca_time_horizon"],
                      env["time_step"], env["orca_safety_space"])


def human_velocities(robot: Tensor, humans: Tensor, env: Mapping) -> Tensor:
    """ORCA velocities of the humans [B, N, 9] (the robot an obstacle only
    when visible) -> [B, N, 2]."""
    if env["human_policy"] != "orca":
        raise ValueError("the reference steps ORCA humans only")
    n = humans.shape[-2]
    to_goal = humans[..., GX:GY + 1] - humans[..., :2]
    dist = _norm2(to_goal)[..., None]
    reached = dist[..., 0] < humans[..., RADIUS]
    pref = torch.where(reached[..., None], 0.0,
                       to_goal / torch.clamp(dist, min=1e-9)
                       * humans[..., VPREF, None])
    pos, vel = humans[..., :2], humans[..., VX:VY + 1]
    rad, vpref, prefv = humans[..., RADIUS], humans[..., VPREF], pref
    if env["robot_visible"]:
        pos = torch.cat([pos, robot[..., None, :2]], -2)
        vel = torch.cat([vel, robot[..., None, VX:VY + 1]], -2)
        rad = torch.cat([rad, robot[..., RADIUS, None]], -1)
        vpref = torch.cat([vpref, robot[..., VPREF, None]], -1)
        prefv = torch.cat([prefv, robot[..., None, VX:VY + 1]], -2)
    active = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    new_v = centralized_orca_step(pos, vel, rad, prefv, vpref, active,
                                  orca_params(env))
    return new_v[..., :n, :]


class Step(NamedTuple):
    robot: Tensor  # [B, 9]
    humans: Tensor  # [B, N, 9]
    reward: Tensor
    done: Tensor
    outcome: Tensor
    dmin: Tensor


def env_step(robot: Tensor, humans: Tensor, step: Tensor, action: Tensor,
             env: Mapping) -> Step:
    """One step of live envs: robot [B, 9], humans [B, N, 9] full states,
    ``step`` [B] the steps taken, action [B, 2] -> the next state."""
    dt = env["time_step"]
    hv = human_velocities(robot, humans, env)
    t_next = (step.to(torch.float32) + 1.0) * dt
    r = reward(robot, humans[..., :5], hv, action, t_next, env)
    nxt_h = torch.cat([humans[..., :2] + hv * dt, hv, humans[..., RADIUS:]],
                      -1)
    return Step(propagate(robot, action, dt), nxt_h, r.reward, r.done,
                r.outcome, r.dmin)


def in_precision(dtype, fn, *args):
    """``fn`` on its float tensors cast to ``dtype``, its float results
    cast back to float32 (the control's lower precision)."""
    def cast(x, to):
        return x.to(to) if isinstance(x, Tensor) and x.is_floating_point() \
            else x
    out = fn(*(cast(a, dtype) for a in args))
    back = [cast(o, torch.float32) for o in out]
    return type(out)(*back) if hasattr(out, "_fields") else tuple(back)


# --------------------------------------------------------------------- nets
def _mlp(x: Tensor, P: Mapping, prefix: str, last_relu: bool) -> Tensor:
    n = sum(1 for k in P if k.startswith(prefix + "/dense_")
            and k.endswith("/kernel"))
    for i in range(n):
        x = x @ P[f"{prefix}/dense_{i}/kernel"] + P[f"{prefix}/dense_{i}/bias"]
        if i < n - 1 or last_relu:
            x = torch.relu(x)
    return x


def rgl(robot: Tensor, humans: Tensor, P: Mapping, prefix: str) -> Tensor:
    """The relational graph model: robot and human embeddings as nodes, an
    embedded-Gaussian relation matrix A = softmax(X·Wa·Xᵀ) recomputed before
    each layer, H <- relu(A·H·W) -> node embeddings [..., N+1, d]."""
    H = torch.cat([_mlp(robot, P, prefix + "/w_r", True)[..., None, :],
                   _mlp(humans, P, prefix + "/w_h", True)], -2)
    layers = sorted(k for k in P if k.startswith(prefix + "/gcn_w"))
    for key in layers:
        A = torch.softmax((H @ P[prefix + "/w_a/kernel"])
                          @ H.transpose(-1, -2), dim=-1)
        H = torch.relu(A @ (H @ P[key]))
    return H


def value(robot: Tensor, humans: Tensor, P: Mapping) -> Tensor:
    """V(s) [...] from robot [..., 9] and observable humans [..., N, 5]."""
    H = rgl(robot, humans, P, "value_graph_model")
    return _mlp(H[..., 0, :], P, "value_network", False)[..., 0]


def predict_humans(robot: Tensor, humans: Tensor, P: Mapping) -> Tensor:
    """The state predictor's next observable humans [..., N, 5]."""
    H = rgl(robot, humans, P, "pred_graph_model")
    return _mlp(H[..., 1:, :], P, "human_motion_predictor", False)


# ------------------------------------------------------------------ planner
def action_space(policy: Mapping, v_pref: float, device) -> Tensor:
    """Stop, then 16 directions × 5 exponentially spaced speeds
    (holonomic, (vx, vy)) -> [81, 2]."""
    a = policy["action_space"]
    speeds = [(np.exp((i + 1) / a["speed_samples"]) - 1) / (np.e - 1)
              * v_pref for i in range(a["speed_samples"])]
    acts = [np.zeros(2, np.float32)]
    for rot in np.linspace(0, 2 * np.pi, a["rotation_samples"],
                           endpoint=False):
        for s in speeds:
            acts.append(np.array([s * np.cos(rot), s * np.sin(rot)],
                                 np.float32))
    return torch.as_tensor(np.stack(acts), device=device)


class Planner:
    """V_planning(s, d, w) = max over the top-w actions by one-step value of
    V(s)/d + (d−1)/d·[R̂(s,a) + γ̄·V_planning(ŝ', d−1, w)], V at the leaves;
    ŝ' from the state predictor, R̂ the reward with humans at their observed
    velocities and no time limit."""

    def __init__(self, config: Mapping, P: Mapping, device):
        self.env, pol = config["env"], config["policy"]
        mprl = pol["mprl"]
        if not mprl["do_action_clip"] or mprl["sparse_search"] \
                or mprl["linear_state_predictor"] or mprl["canonicalize"] \
                or config["env"]["robot_kinematics"] != "holonomic":
            raise ValueError("the reference plans the paper's MP-RGL only")
        self.P, self.gamma = P, pol["gamma"]
        self.depth, self.width = mprl["planning_depth"], mprl["planning_width"]
        self.actions = action_space(pol, self.env["robot_v_pref"], device)

    def gamma_bar(self, robot: Tensor) -> Tensor:
        return torch.pow(self.gamma, self.env["time_step"] * robot[..., VPREF])

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

    def one_step(self, robot, humans):
        r, nr, nh = self.expand(robot, humans)
        return r + self.gamma_bar(robot)[..., None] * value(nr, nh, self.P), \
            r, nr, nh

    def v_planning(self, robot: Tensor, humans: Tensor, depth: int) -> Tensor:
        v = value(robot, humans, self.P)
        if depth <= 1:
            return v
        v1, r, nr, nh = self.one_step(robot, humans)
        idx = torch.sort(v1, dim=-1, descending=True,
                         stable=True).indices[..., :self.width]
        r = torch.gather(r, -1, idx)
        nr = torch.gather(nr, -2, idx[..., None].expand(idx.shape + (9,)))
        nh = torch.gather(nh, -3, idx[..., None, None].expand(
            idx.shape + nh.shape[-2:]))
        ret = v[..., None] / depth + (depth - 1) / depth * (
            r + self.gamma_bar(robot)[..., None]
            * self.v_planning(nr, nh, depth - 1))
        return ret.amax(-1)

    @torch.no_grad()
    def root(self, robot: Tensor, humans: Tensor):
        """For states [S]: the one-step values v1 [S, A] that clip the root
        and each action's planning return Q [S, A]."""
        v1, r, nr, nh = self.one_step(robot, humans)
        q = r + self.gamma_bar(robot)[..., None] * self.v_planning(
            nr, nh, self.depth)
        return v1, q

    @torch.no_grad()
    def decide(self, robot: Tensor, humans: Tensor, block: int = 8):
        """The planner's action [S, 2] and the root's v1 and Q [S, A], in
        blocks of ``block`` states."""
        v1s, qs = [], []
        for i in range(0, robot.shape[0], block):
            v1, q = self.root(robot[i:i + block], humans[i:i + block])
            v1s.append(v1)
            qs.append(q)
        v1, q = torch.cat(v1s), torch.cat(qs)
        top = torch.sort(v1, dim=-1, descending=True,
                         stable=True).indices[..., :self.width]
        best = torch.gather(top, -1, torch.argmax(
            torch.gather(q, -1, top), -1, keepdim=True))[..., 0]
        return self.actions[best], v1, q

    def gap(self, v1: Tensor, q: Tensor, acts: Tensor,
            tie: float = 1e-5) -> Tensor:
        """How far the return of each given action [S, 2] lies below the
        planner's best [S]. The root keeps the top w by v1; actions whose
        v1 lies within ``tie`` (relative) of the w-th are a near tie that
        float32 rounding may order either way, so every clip set such a
        tie allows is tried and the smallest gap counts. An action that no
        such clip keeps, or that is not one of the 81, is no decision of
        the planner: it reads ``NOT_PLANNED``. The band is one test, in
        float64: each of the top w is in it or kept for sure, so some clip
        is always tried."""
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
            best = NOT_PLANNED
            for rest in itertools.combinations(near, w - len(sure)):
                clip = sure + list(rest)
                if a in clip:
                    best = min(best, float(q[s, clip].max() - q[s, a]))
            out.append(best)
        return torch.tensor(out, dtype=torch.float64)


# ------------------------------------------------------------------ training
def td_target(batch: Mapping, target: Mapping, config: Mapping) -> Tensor:
    """r + γ^(Δt·v_pref)·(1 − terminal)·V_target(s')."""
    pol, env = config["policy"], config["env"]
    gb = torch.pow(pol["gamma"], env["time_step"] * batch["robot"][..., VPREF])
    with torch.no_grad():
        v_next = value(batch["next_robot"], batch["next_humans"], target)
    return batch["reward"] + gb * (1.0 - batch["terminal"]) * v_next


def losses(P: Mapping, batch: Mapping, target: Mapping, config: Mapping,
           update_sp: float):
    """(value loss, predictor loss): the valid-weighted MSE of V to the TD
    target, and of the predicted next humans to the observed ones, scaled
    by ``update_sp``."""
    w = batch["valid"]
    denom = torch.clamp(w.sum(), min=1.0)
    v = value(batch["robot"], batch["humans"], P)
    pred = predict_humans(batch["robot"], batch["humans"], P)
    vloss = (w * (v - td_target(batch, target, config)) ** 2).sum() / denom
    ploss = ((w[..., None, None] * (pred - batch["next_humans"]) ** 2).sum()
             / (denom * pred.shape[-1] * pred.shape[-2]) * update_sp)
    return vloss, ploss


class Adam:
    """Adam (β = 0.9, 0.999, ε = 1e-8) behind a clip of the global
    gradient norm at ``max_norm``, on a dict of leaves."""

    def __init__(self, P: Mapping, lr: float, max_norm: float = 10.0):
        self.lr, self.max_norm, self.t = lr, max_norm, 0
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}

    @torch.no_grad()
    def step(self, P: dict, grads: Mapping) -> dict:
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values()))
        scale = min(1.0, self.max_norm / norm) if norm > 0 else 1.0
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        out = {}
        for k, p in P.items():
            g = grads[k] * scale
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + eps)
        return out


def train_steps(P: Mapping, target: Mapping, batches, sp_flags,
                config: Mapping, state=None) -> dict:
    """Follow the program's SGD steps from the same weights on the same
    minibatches -> {"losses": [(value, predictor)] a step, "grads": the
    first step's clipped gradients, "params": after them}. ``state``:
    Adam's moments and step count (m, v, t) to start from; fresh when
    None."""
    lr = config["train"]["rl_learning_rate"]
    P = {k: v.clone() for k, v in P.items()}
    opt = Adam(P, lr)
    if state is not None:
        m, v, opt.t = state
        opt.m = {k: x.clone() for k, x in m.items()}
        opt.v = {k: x.clone() for k, x in v.items()}
    out = {"losses": []}
    for i, (batch, sp) in enumerate(zip(batches, sp_flags)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        vloss, ploss = losses(leaves, batch, target, config, sp)
        grads = torch.autograd.grad(vloss + ploss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = dict(zip(leaves, grads))
        out["losses"].append((float(vloss.detach()), float(ploss.detach())))
        if i == 0:
            norm = math.sqrt(sum(float((g.double() ** 2).sum())
                                 for g in grads.values()))
            scale = min(1.0, opt.max_norm / norm) if norm > 0 else 1.0
            out["grads"] = {k: g * scale for k, g in grads.items()}
        P = opt.step(P, grads)
    out["params"] = P
    return out
