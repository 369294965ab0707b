"""Checkpoints in torch's format (port of
``relationalgraphlearning_tpu/training/checkpoint.py``).

A checkpoint is a directory, as the reference's orbax one is (``il_model``,
``rl_model``, ``rl_model_best`` under a run's ``output_dir``), holding
``state.pt``: the trainer's ``state_dict`` (params, target params, the
optimizer's kind, rate, moments and step count), what the reference's
``TrainState`` holds.
"""

from __future__ import annotations

import os

import torch

FILE = "state.pt"


def save(path: str, trainer) -> None:
    save_state(path, trainer.state_dict())


def save_state(path: str, state: dict) -> None:
    """Write a trainer's ``state_dict`` as the checkpoint ``path``."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def load(path: str, map_location="cpu") -> dict:
    """The saved ``state_dict`` (tensors on ``map_location``)."""
    return torch.load(os.path.join(path, FILE), map_location=map_location,
                      weights_only=True)


def restore(path: str, trainer, keep_optimizer: bool = False) -> None:
    """Load a checkpoint into ``trainer``'s live tensors, in place
    (``keep_optimizer``: the trainer's optimizer kind and rate stay, see
    ``MPRLTrainer.load_state``)."""
    trainer.load_state(load(path), keep_optimizer)


def exists(path: str) -> bool:
    return os.path.isfile(os.path.join(path, FILE))
