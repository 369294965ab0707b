"""Geometry primitives over arbitrary leading batch dimensions (port of
``relationalgraphlearning_tpu/geometry.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T


def norm2(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(v * v))``."""
    return torch.sqrt((v * v).sum(-1))


def point_to_segment_dist(p1: Tensor, p2: Tensor, q: Tensor) -> Tensor:
    """Distance from point(s) ``q`` to segment(s) ``p1``->``p2`` ([..., 2],
    broadcasting): the projection parameter clamped to [0, 1]; a degenerate
    segment reduces to the point distance."""
    seg = p2 - p1
    seg_sq = (seg * seg).sum(-1, keepdim=True)
    t = ((q - p1) * seg).sum(-1, keepdim=True) / torch.clamp(seg_sq,
                                                             min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return norm2(q - (p1 + t * seg))


def propagate_full_state(state: Tensor, action: Tensor, dt,
                         kinematics: str) -> Tensor:
    """Advance a FullState[..., 9] by one step under ``action``.

    Holonomic: action = [vx, vy]. Unicycle: action = [v, dtheta]; the heading
    turns first, then the agent moves along the new heading.
    """
    if kinematics == T.HOLONOMIC:
        vx, vy = action[..., 0], action[..., 1]
        theta = state[..., T.THETA]
    elif kinematics == T.UNICYCLE:
        theta = state[..., T.THETA] + action[..., 1]
        vx = action[..., 0] * torch.cos(theta)
        vy = action[..., 0] * torch.sin(theta)
    else:
        raise ValueError(f"unknown kinematics: {kinematics}")
    px = state[..., T.PX] + vx * dt
    py = state[..., T.PY] + vy * dt
    vx, vy, theta = torch.broadcast_tensors(vx, vy, theta)
    return torch.cat([torch.stack([px, py, vx, vy], -1),
                      state[..., T.RADIUS:T.THETA], theta[..., None]], -1)


def reached_destination(full_state: Tensor,
                        tol: Optional[Tensor] = None) -> Tensor:
    """True where the agent is within its radius (or ``tol``) of its goal."""
    d = norm2(T.goal(full_state) - T.position(full_state))
    if tol is None:
        tol = full_state[..., T.RADIUS]
    return d < tol


def holonomic_to_unicycle(action: Tensor, theta: Tensor,
                          rotation_constraint: float) -> Tensor:
    """A holonomic (vx, vy) action as a feasible unicycle (v, dtheta) for an
    agent heading ``theta``: turn toward the commanded velocity, clipped to
    ±``rotation_constraint``, with the speed scaled by the cosine of the
    heading error left (never negative: a large error turns in place)."""
    vx, vy = action[..., 0], action[..., 1]
    speed = torch.sqrt(vx * vx + vy * vy)
    err = torch.atan2(vy, vx) - theta
    err = torch.atan2(torch.sin(err), torch.cos(err))  # wrap to [-pi, pi]
    dtheta = torch.clamp(err, -rotation_constraint, rotation_constraint)
    dtheta = torch.where(speed > 1e-6, dtheta, torch.zeros_like(dtheta))
    v = speed * torch.clamp(torch.cos(err - dtheta), min=0.0)
    return torch.stack([v, dtheta], dim=-1)
