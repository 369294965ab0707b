"""Experience replay: a ring of transitions on the device (port of
``relationalgraphlearning_tpu/training/replay_buffer.py``).

A slot holds (state, value target, reward, next state, valid, terminal):
9 + 5·N + 1 + 1 + 9 + 5·N + 1 + 1 floats, 72 at N = 5 (28.8 MB at
100,000 slots). ``push`` writes a flat batch at the ring pointer, wrapping;
``sample`` gathers the rows at given indices, so a captured step can take
them as an input; ``valid`` weights the loss (the trailing incomplete
episode of an imitation rollout has no target).

``ptr`` and ``size`` are host ints: they follow from the push sizes alone,
so a push syncs nothing with the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class Transition(NamedTuple):
    robot: Tensor  # [..., 9]
    humans: Tensor  # [..., N, 5]
    value: Tensor  # [...] stored target (MC return for IL; TD for RL)
    reward: Tensor  # [...]
    next_robot: Tensor  # [..., 9]
    next_humans: Tensor  # [..., N, 5]
    valid: Tensor  # [...] float 0/1
    terminal: Tensor  # [...] float 0/1: the episode ended here


class ReplayBuffer:
    """``data``: a ``Transition`` of arrays [capacity, ...], written in
    place; ``ptr``: the next slot; ``size``: the filled slots."""

    def __init__(self, data: Transition, ptr: int = 0, size: int = 0):
        self.data = data
        self.ptr = ptr
        self.size = size

    @property
    def capacity(self) -> int:
        return self.data.reward.shape[0]


def create(capacity: int, human_num: int, device="cuda") -> ReplayBuffer:
    def zeros(*shape):
        return torch.zeros((capacity, *shape), device=device)

    return ReplayBuffer(Transition(
        robot=zeros(9), humans=zeros(human_num, 5), value=zeros(),
        reward=zeros(), next_robot=zeros(9), next_humans=zeros(human_num, 5),
        valid=zeros(), terminal=zeros()))


def push(buffer: ReplayBuffer, batch: Transition) -> ReplayBuffer:
    """Write a flat batch [K, ...] (on any device) at slots
    (ptr + arange(K)) % capacity."""
    K, cap = batch.reward.shape[0], buffer.capacity
    idx = (buffer.ptr + torch.arange(K, device=buffer.data.reward.device)) \
        % cap
    for dst, src in zip(buffer.data, batch):
        dst.index_copy_(0, idx, src.to(dst))
    buffer.ptr = (buffer.ptr + K) % cap
    buffer.size = min(buffer.size + K, cap)
    return buffer


def sample_indices(buffer: ReplayBuffer, generator: torch.Generator,
                   shape) -> Tensor:
    """Uniform slot indices over the filled region, int64 of ``shape``, in
    one launch (every minibatch of a sweep at once)."""
    return torch.randint(0, max(buffer.size, 1), tuple(shape),
                         generator=generator,
                         device=buffer.data.reward.device)


def sample(buffer: ReplayBuffer, idx: Tensor) -> Transition:
    """The transitions at slot indices ``idx`` [batch]."""
    return Transition(*(a.index_select(0, idx) for a in buffer.data))


def clear(buffer: ReplayBuffer) -> ReplayBuffer:
    buffer.data.valid.zero_()
    buffer.ptr = buffer.size = 0
    return buffer


def is_full(buffer: ReplayBuffer) -> bool:
    return buffer.size >= buffer.capacity
