"""State layouts and outcome codes (port of ``relationalgraphlearning_tpu/types.py``).

States are tensors with free leading batch dimensions:

  FullState[9]       = [px, py, vx, vy, radius, gx, gy, v_pref, theta]
  ObservableState[5] = [px, py, vx, vy, radius]

Actions are 2-vectors: holonomic ``ActionXY=[vx, vy]``; unicycle
``ActionRot=[v, dtheta]``. Which one applies is a configuration choice
(``kinematics``), never data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

# FullState component indices.
PX, PY, VX, VY, RADIUS, GX, GY, VPREF, THETA = range(9)

FULL_STATE_DIM = 9
OBSERVABLE_STATE_DIM = 5

HOLONOMIC = "holonomic"
UNICYCLE = "unicycle"


class JointState(NamedTuple):
    """Robot full state [..., 9] and observable human states [..., N, 5]:
    the policy's input."""

    robot: Tensor
    humans: Tensor


def observable(full_states: Tensor) -> Tensor:
    """FullState[..., 9] -> ObservableState[..., 5] (px, py, vx, vy, radius)."""
    return full_states[..., :OBSERVABLE_STATE_DIM]


def full_state(px, py, vx, vy, radius, gx, gy, v_pref, theta,
               dtype=torch.float32, device=None) -> Tensor:
    parts = torch.broadcast_tensors(*(
        torch.as_tensor(x, dtype=dtype, device=device)
        for x in (px, py, vx, vy, radius, gx, gy, v_pref, theta)))
    return torch.stack(parts, dim=-1)


def position(states: Tensor) -> Tensor:
    return states[..., PX:PY + 1]


def velocity(states: Tensor) -> Tensor:
    return states[..., VX:VY + 1]


def goal(full_states: Tensor) -> Tensor:
    return full_states[..., GX:GY + 1]


def radius(states: Tensor) -> Tensor:
    return states[..., RADIUS]


# Episode outcome codes, as in the reference (Nothing/ReachGoal/Collision/
# Timeout); danger is reported as a minimum separation, not an outcome.
OUTCOME_NOTHING = 0
OUTCOME_REACH_GOAL = 1
OUTCOME_COLLISION = 2
OUTCOME_TIMEOUT = 3
