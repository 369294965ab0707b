"""The MP-RGL network bundle, value estimator and state predictor (port of
``relationalgraphlearning_tpu/models/mprl_networks.py``).

With ``share_graph_model`` the two heads share one RGL graph model (the
value one); otherwise each owns its own; with ``linear_state_predictor``
the humans propagate at constant velocity and no predictor exists. With
``canonicalize`` the nets read the scene in the goal frame.

Submodules are named as in the flax tree: ``value_graph_model``,
``pred_graph_model``, ``value_network``, ``human_motion_predictor``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor, nn

from relationalgraphlearning_tpu_torch import geometry
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import PolicyConfig
from relationalgraphlearning_tpu_torch.models.mlp import MLP
from relationalgraphlearning_tpu_torch.models.rgl import RGL
from relationalgraphlearning_tpu_torch.models.state_predictor import (
    propagate_humans_linear)
from relationalgraphlearning_tpu_torch.policies.state_transform import (
    canonicalize_scene, decanonicalize_humans)


class MPRLNetworks(nn.Module):
    def __init__(self, cfg: PolicyConfig, time_step: float = 0.25,
                 kinematics: str = T.HOLONOMIC):
        super().__init__()
        self.cfg = cfg
        self.time_step = time_step
        self.kinematics = kinematics
        mprl = cfg.mprl
        self.value_graph_model = RGL(cfg.gcn)
        if not (mprl.share_graph_model or mprl.linear_state_predictor):
            self.pred_graph_model = RGL(cfg.gcn)
        width = self.value_graph_model.out_dim
        self.value_network = MLP(width, mprl.value_network_dims)
        if not mprl.linear_state_predictor:
            self.human_motion_predictor = MLP(width,
                                              mprl.motion_predictor_dims)

    @property
    def pred_graph(self) -> Optional[RGL]:
        """The state predictor's graph model (the value one when shared)."""
        if self.cfg.mprl.linear_state_predictor:
            return None
        if self.cfg.mprl.share_graph_model:
            return self.value_graph_model
        return self.pred_graph_model

    def _canon(self, robot: Tensor, humans: Tensor):
        if not self.cfg.mprl.canonicalize:
            return robot, humans, None
        return canonicalize_scene(robot, humans)

    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        """robot [..., 9], humans [..., N, 5] -> V(s) [...]."""
        robot_c, humans_c, _ = self._canon(robot, humans)
        H, _ = self.value_graph_model(robot_c, humans_c)
        return self.value_network(H[..., 0, :])[..., 0]

    def attention(self, robot: Tensor, humans: Tensor) -> Tensor:
        """The value graph model's relation matrix, for visualization."""
        robot_c, humans_c, _ = self._canon(robot, humans)
        return self.value_graph_model(robot_c, humans_c)[1]

    def next_state(self, robot: Tensor, humans: Tensor, action: Tensor
                   ) -> Tuple[Tensor, Tensor]:
        """-> (next_robot [..., 9], next_humans [..., N, 5])."""
        next_robot = geometry.propagate_full_state(
            robot, action, self.time_step, self.kinematics)
        if self.cfg.mprl.linear_state_predictor:
            return next_robot, propagate_humans_linear(humans, self.time_step)
        robot_c, humans_c, rot = self._canon(robot, humans)
        H, _ = self.pred_graph(robot_c, humans_c)
        next_humans = self.human_motion_predictor(H[..., 1:, :])
        if rot is not None:
            next_humans = decanonicalize_humans(next_humans, robot, rot)
        return next_robot, next_humans
