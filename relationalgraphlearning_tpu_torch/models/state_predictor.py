"""Trajectory (state) predictor (port of ``relationalgraphlearning_tpu/models/state_predictor.py``).

``StatePredictor``: the RGL graph model and the ``human_motion_predictor``
MLP over the human nodes' embeddings give the humans' next observable
states; the robot's next state follows from the action by its kinematics.
``linear_state_predictor`` is the constant-velocity baseline.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import Tensor, nn

from relationalgraphlearning_tpu_torch import geometry
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.models.mlp import MLP
from relationalgraphlearning_tpu_torch.models.rgl import RGL


def propagate_humans_linear(humans: Tensor, dt) -> Tensor:
    """Constant-velocity propagation of ObservableState[..., N, 5]."""
    return torch.cat([humans[..., :2] + humans[..., 2:4] * dt,
                      humans[..., 2:]], -1)


class StatePredictor(nn.Module):
    def __init__(self, gcn: GCNConfig,
                 motion_predictor_dims: Sequence[int] = (64, 5),
                 time_step: float = 0.25, kinematics: str = T.HOLONOMIC):
        super().__init__()
        self.graph_model = RGL(gcn)
        self.human_motion_predictor = MLP(self.graph_model.out_dim,
                                          motion_predictor_dims)
        self.time_step = time_step
        self.kinematics = kinematics

    def forward(self, robot: Tensor, humans: Tensor, action: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """(robot [..., 9], humans [..., N, 5], action [..., 2]) ->
        (next_robot [..., 9], next_humans [..., N, 5])."""
        H, _ = self.graph_model(robot, humans)
        next_humans = self.human_motion_predictor(H[..., 1:, :])
        next_robot = geometry.propagate_full_state(
            robot, action, self.time_step, self.kinematics)
        return next_robot, next_humans


def linear_state_predictor(robot: Tensor, humans: Tensor, action: Tensor,
                           time_step: float, kinematics: str
                           ) -> Tuple[Tensor, Tensor]:
    """Humans at constant velocity; the robot by its kinematics."""
    next_robot = geometry.propagate_full_state(robot, action, time_step,
                                               kinematics)
    return next_robot, propagate_humans_linear(humans, time_step)
