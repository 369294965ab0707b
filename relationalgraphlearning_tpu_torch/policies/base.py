"""Exploration (port of ``epsilon_greedy`` from
``relationalgraphlearning_tpu/policies/base.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def epsilon_greedy(greedy_action: Tensor, action_space: Tensor,
                   epsilon=0.0,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """A uniformly random action of ``action_space`` [A, 2] with probability
    ``epsilon`` (a float or a 0-d tensor), else ``greedy_action`` [..., 2].

    The draws, an action index in [0, A) and a uniform in [0, 1) for each
    decision, are ``draws`` when given (as a captured step takes them),
    else they come from ``generator``. Without either nothing is drawn,
    which only ε = 0 allows (evaluation); at ε = 0 the greedy action is
    returned whatever is drawn.
    """
    if draws is None:
        if generator is None:
            if isinstance(epsilon, Tensor) or epsilon != 0:
                raise ValueError("exploration with epsilon > 0 needs a "
                                 "generator or draws")
            return greedy_action
        shape, dev = greedy_action.shape[:-1], greedy_action.device
        draws = (torch.randint(0, action_space.shape[0], shape,
                               generator=generator, device=dev),
                 torch.rand(shape, generator=generator, device=dev))
    idx, u = draws
    explore = u < epsilon
    return torch.where(explore[..., None], action_space[idx], greedy_action)
