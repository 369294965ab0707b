"""Goal-frame canonicalization of a scene (port of ``canonicalize_scene``
and ``decanonicalize_humans`` from
``relationalgraphlearning_tpu/policies/state_transform.py``).

The crowd environment is isotropic, so the MP-RGL nets may read the scene in
the frame whose origin is the robot and whose x-axis points at its goal
(``MPRLConfig.canonicalize``); the predicted human states rotate back to the
world frame. State layouts are unchanged. Everything broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T


def _rot(x: Tensor, y: Tensor, c: Tensor, s: Tensor):
    return x * c + y * s, y * c - x * s


def canonicalize_scene(robot: Tensor, humans: Tensor):
    """(robot [..., 9], humans [..., N, 5]) -> (robot_c, humans_c, rot), rot
    the world -> canonical rotation angle [...]."""
    px, py = robot[..., T.PX], robot[..., T.PY]
    dx = robot[..., T.GX] - px
    dy = robot[..., T.GY] - py
    dg = torch.sqrt(dx * dx + dy * dy)
    rot = torch.where(dg > 1e-6, torch.atan2(dy, dx), torch.zeros_like(dg))
    cos_r, sin_r = torch.cos(rot), torch.sin(rot)

    rvx, rvy = _rot(robot[..., T.VX], robot[..., T.VY], cos_r, sin_r)
    theta = robot[..., T.THETA] - rot
    theta = torch.atan2(torch.sin(theta), torch.cos(theta))
    zero = torch.zeros_like(px)
    robot_c = torch.stack([zero, zero, rvx, rvy, robot[..., T.RADIUS], dg,
                           zero, robot[..., T.VPREF], theta], -1)

    cn, sn = cos_r[..., None], sin_r[..., None]
    hpx, hpy = _rot(humans[..., T.PX] - px[..., None],
                    humans[..., T.PY] - py[..., None], cn, sn)
    hvx, hvy = _rot(humans[..., T.VX], humans[..., T.VY], cn, sn)
    humans_c = torch.cat([torch.stack([hpx, hpy, hvx, hvy], -1),
                          humans[..., T.RADIUS:]], -1)
    return robot_c, humans_c, rot


def decanonicalize_humans(humans_c: Tensor, robot: Tensor,
                          rot: Tensor) -> Tensor:
    """Canonical-frame human observable states back to the world frame (the
    inverse of ``canonicalize_scene`` for the predictor's outputs)."""
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    hpx, hpy = _rot(humans_c[..., T.PX], humans_c[..., T.PY], c, -s)
    hvx, hvy = _rot(humans_c[..., T.VX], humans_c[..., T.VY], c, -s)
    return torch.cat([torch.stack([hpx + robot[..., None, T.PX],
                                   hpy + robot[..., None, T.PY], hvx, hvy],
                                  -1), humans_c[..., T.RADIUS:]], -1)
