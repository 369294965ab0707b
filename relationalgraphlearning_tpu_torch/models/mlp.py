"""MLP helper (port of ``relationalgraphlearning_tpu/models/mlp.py``).

torch needs the input width that flax infers, so ``MLP`` takes ``in_dim``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def init_linear_(layer: nn.Linear, generator: Optional[torch.Generator]
                 ) -> nn.Linear:
    """Re-draw a Linear's weights from ``generator`` with torch's default
    bounds, U(±1/√fan_in), so seeded models do not touch the global RNG."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class MLP(nn.Module):
    """Linear/ReLU stack: ReLU after every layer except (optionally) the
    last. ``layers[i]`` is flax's ``dense_i``."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 last_relu: bool = False):
        super().__init__()
        widths = [in_dim, *dims]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(len(dims)))
        self.last_relu = last_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last or self.last_relu:
                x = torch.relu(x)
        return x
