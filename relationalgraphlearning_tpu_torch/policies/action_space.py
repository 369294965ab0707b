"""Discrete robot action space (port of ``relationalgraphlearning_tpu/policies/action_space.py``).

``speed_samples`` exponentially spaced speeds (e^(i/n)-1)/(e-1)·v_pref ×
``rotation_samples`` directions, plus the stop action first: 81 actions for
the 5 × 16 default. Holonomic: directions span [0, 2π) and an action is
(vx, vy); unicycle: rotations span ±rotation_constraint and an action is
(speed, dθ). Built once on the host (numpy); the planner moves it to its
device.
"""

from __future__ import annotations

import numpy as np

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import ActionSpaceConfig


def build_action_space(cfg: ActionSpaceConfig, v_pref: float,
                       kinematics: str) -> np.ndarray:
    speeds = [(np.exp((i + 1) / cfg.speed_samples) - 1) / (np.e - 1) * v_pref
              for i in range(cfg.speed_samples)]
    if kinematics == T.HOLONOMIC:
        rotations = np.linspace(
            0, 2 * np.pi, cfg.rotation_samples, endpoint=False)
    else:
        rotations = np.linspace(
            -cfg.rotation_constraint, cfg.rotation_constraint,
            cfg.rotation_samples)

    actions = [np.zeros(2, np.float32)]  # stop / (0 speed, 0 rotation)
    for rotation in rotations:
        for speed in speeds:
            if kinematics == T.HOLONOMIC:
                actions.append(np.array(
                    [speed * np.cos(rotation), speed * np.sin(rotation)],
                    np.float32))
            else:
                actions.append(np.array([speed, rotation], np.float32))
    return np.stack(actions)  # [A, 2]


def build_action_group_index(cfg: ActionSpaceConfig, sparse_speed_samples: int,
                             sparse_rotation_samples: int) -> np.ndarray:
    """Coarse (speed, rotation) bucket id per action, aligned with
    ``build_action_space`` ordering (stop first, then rotation-major).

    Parity: ``ModelPredictiveRL``'s ``self.action_group_index`` used by the
    ``sparse_search`` branch of ``action_clip`` — clipped actions are the
    highest-valued ones drawn from *distinct* coarse buckets, forcing
    directional diversity into the planning tree.
    """
    groups = [0]  # stop action: its own group
    for i in range(cfg.rotation_samples):
        rot_bucket = i * sparse_rotation_samples // cfg.rotation_samples
        for j in range(cfg.speed_samples):
            speed_bucket = j * sparse_speed_samples // cfg.speed_samples
            groups.append(1 + rot_bucket * sparse_speed_samples + speed_bucket)
    return np.asarray(groups, np.int32)  # [A]
