"""From-scratch initialisation as flax's defaults draw it (the counterpart of
``init_params`` in ``relationalgraphlearning_tpu/policies/model_predictive_rl.py``,
which calls ``MPRLNetworks.init``).

The JAX models set no ``kernel_init``, so every ``Dense`` kernel comes from
``lecun_normal``: ``variance_scaling(1.0, "fan_in", "truncated_normal")``,
a normal truncated at ±2 of its σ and scaled so that the truncated draw has
the standard deviation 1/√fan_in; every bias is zero. torch's default
(Kaiming-uniform) is another distribution, so it is replaced here. An LSTM
cell's hidden-to-hidden kernels (flax's ``recurrent_kernel_init``) are
``orthogonal`` instead; the port's LSTM-RL marks those layers
``recurrent``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's constant)
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every ``nn.Linear`` of ``module`` in place: weights from the
    truncated normal of σ = 1/(√fan_in · 0.8796), cut at ±2σ (a square
    orthogonal matrix for a layer with ``recurrent`` set), biases zero.

    Draws come from ``generator`` (a CPU generator, so one seed gives the
    same weights on any device) in the order of ``module.modules()``.
    """
    with torch.no_grad():
        for layer in module.modules():
            if not isinstance(layer, nn.Linear):
                continue
            w = torch.empty(layer.weight.shape, dtype=layer.weight.dtype)
            if getattr(layer, "recurrent", False):
                nn.init.orthogonal_(w, generator=generator)
            else:
                std = 1.0 / math.sqrt(layer.in_features) / _TRUNCATED_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            layer.weight.copy_(w)
            if layer.bias is not None:
                layer.bias.zero_()
    return module
