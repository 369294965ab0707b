"""Exploration (port of ``epsilon_greedy`` from
``relationalgraphlearning_tpu/policies/base.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def epsilon_greedy(greedy_action: Tensor, action_space: Tensor,
                   epsilon: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> Tensor:
    """A uniformly random action of ``action_space`` [A, 2] with probability
    ``epsilon``, else ``greedy_action`` [..., 2].

    The draws come from ``generator``. Without one nothing is drawn, which
    only ε = 0 allows (evaluation); at ε = 0 the greedy action is returned
    whatever is drawn.
    """
    if generator is None:
        if epsilon != 0:
            raise ValueError("exploration with epsilon > 0 needs a generator")
        return greedy_action
    shape, dev = greedy_action.shape[:-1], greedy_action.device
    idx = torch.randint(0, action_space.shape[0], shape, generator=generator,
                        device=dev)
    explore = torch.rand(shape, generator=generator, device=dev) < epsilon
    return torch.where(explore[..., None], action_space[idx], greedy_action)
