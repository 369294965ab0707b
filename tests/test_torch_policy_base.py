"""The port's epsilon_greedy: at ε = 0 the greedy action whatever is
drawn; at ε = 1 an action of the space, drawn from the given generator
(the same seed the same draws); without a generator only ε = 0."""

import pytest
import torch

from relationalgraphlearning_tpu_torch.configs.base import ActionSpaceConfig
from relationalgraphlearning_tpu_torch.policies.action_space import (
    build_action_space)
from relationalgraphlearning_tpu_torch.policies.base import epsilon_greedy

SPACE = torch.from_numpy(build_action_space(ActionSpaceConfig(), 1.0,
                                            "holonomic"))


def _greedy(B=256):
    return torch.full((B, 2), 7.0)  # not an action of the space


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epsilon_zero_returns_greedy_whatever_it_draws(seed):
    g = torch.Generator().manual_seed(seed)
    got = epsilon_greedy(_greedy(), SPACE, 0.0, g)
    assert torch.equal(got, _greedy())
    assert torch.equal(epsilon_greedy(_greedy(), SPACE, 0.0), _greedy())


def test_epsilon_one_explores_from_the_space():
    got = epsilon_greedy(_greedy(), SPACE, 1.0,
                         torch.Generator().manual_seed(3))
    hits = (got[:, None, :] == SPACE[None]).all(-1)
    assert hits.any(-1).all()
    assert len(torch.unique(hits.float().argmax(-1))) > 40
    again = epsilon_greedy(_greedy(), SPACE, 1.0,
                           torch.Generator().manual_seed(3))
    assert torch.equal(got, again)


def test_mixed_epsilon_and_no_generator():
    got = epsilon_greedy(_greedy(4096), SPACE, 0.25,
                         torch.Generator().manual_seed(4))
    share = (got != 7.0).any(-1).float().mean().item()
    assert 0.2 < share < 0.3
    with pytest.raises(ValueError):
        epsilon_greedy(_greedy(), SPACE, 0.1)
