"""Value estimator head (port of ``relationalgraphlearning_tpu/models/value_estimator.py``):
the RGL graph model and an MLP on the robot node's embedding (node 0)."""

from __future__ import annotations

from typing import Sequence

from torch import Tensor, nn

from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.models.mlp import MLP
from relationalgraphlearning_tpu_torch.models.rgl import RGL


class ValueEstimator(nn.Module):
    def __init__(self, gcn: GCNConfig,
                 value_dims: Sequence[int] = (32, 100, 100, 1)):
        super().__init__()
        self.graph_model = RGL(gcn)
        self.value_network = MLP(self.graph_model.out_dim, value_dims)

    def forward(self, robot: Tensor, humans: Tensor) -> Tensor:
        """robot [..., 9], humans [..., N, 5] -> V(s) [...]."""
        H, _ = self.graph_model(robot, humans)
        return self.value_network(H[..., 0, :])[..., 0]
