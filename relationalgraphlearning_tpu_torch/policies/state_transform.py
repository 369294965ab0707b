"""Robot-centric state transforms (port of
``relationalgraphlearning_tpu/policies/state_transform.py``).

``rotate_joint_state`` is the reference's ``CADRL.rotate``: a joint state in
the frame whose x-axis points from the robot to its goal, one 13-wide row a
human (the robot's 6 values, then the human's 7), which the CADRL, SARL and
LSTM-RL value nets read; ``build_occupancy_maps`` is
``MultiHumanRL.build_occupancy_maps``, each human's grid over the other
humans, which SARL with ``with_om`` appends to the rows.

``canonicalize_scene`` moves the whole scene into the goal frame with its
layouts unchanged, as the MP-RGL nets read it with
``MPRLConfig.canonicalize`` (the crowd environment is isotropic); the
predicted human states rotate back with ``decanonicalize_humans``.
Everything broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T


ROTATED_ROBOT_DIM = 6
ROTATED_HUMAN_DIM = 7


def _rot(x: Tensor, y: Tensor, c: Tensor, s: Tensor):
    return x * c + y * s, y * c - x * s


def rotate_joint_state(robot: Tensor, humans: Tensor,
                       kinematics: str) -> Tensor:
    """robot [..., 9], humans [..., N, 5] -> rotated rows [..., N, 13]:
    [dg, v_pref, theta', radius, vx', vy', px1', py1', vx1', vy1', radius1,
    da, radius + radius1], ' in the goal frame; theta' = 0 unless the robot
    is a unicycle."""
    dx = robot[..., T.GX] - robot[..., T.PX]
    dy = robot[..., T.GY] - robot[..., T.PY]
    rot = torch.atan2(dy, dx)
    cos_r, sin_r = torch.cos(rot), torch.sin(rot)
    dg = torch.sqrt(dx * dx + dy * dy)
    vx, vy = _rot(robot[..., T.VX], robot[..., T.VY], cos_r, sin_r)
    radius = robot[..., T.RADIUS]
    theta = robot[..., T.THETA] - rot if kinematics == T.UNICYCLE \
        else torch.zeros_like(rot)
    robot_part = torch.stack([dg, robot[..., T.VPREF], theta, radius, vx, vy],
                             -1)

    hpx = humans[..., T.PX] - robot[..., None, T.PX]
    hpy = humans[..., T.PY] - robot[..., None, T.PY]
    cn, sn = cos_r[..., None], sin_r[..., None]
    px1, py1 = _rot(hpx, hpy, cn, sn)
    vx1, vy1 = _rot(humans[..., T.VX], humans[..., T.VY], cn, sn)
    radius1 = humans[..., T.RADIUS]
    da = torch.sqrt(hpx * hpx + hpy * hpy)
    human_part = torch.stack([px1, py1, vx1, vy1, radius1, da,
                              radius[..., None] + radius1], -1)
    robot_tiled = robot_part[..., None, :].expand(
        human_part.shape[:-1] + (ROTATED_ROBOT_DIM,))
    return torch.cat([robot_tiled, human_part], -1)


def build_occupancy_maps(humans: Tensor, cell_num: int, cell_size: float,
                         om_channel_size: int) -> Tensor:
    """Each human's grid of ``cell_num``² cells of ``cell_size`` around it,
    in its velocity-aligned frame, over the OTHER humans: humans [..., N, 5]
    -> [..., N, cell_num²] counts (``om_channel_size`` 1), else
    [..., N, 3·cell_num²] with each cell's count, mean vx and mean vy
    interleaved ([c0_occ, c0_vx, c0_vy, c1_occ, ...])."""
    n = humans.shape[-2]
    px, py = humans[..., T.PX], humans[..., T.PY]
    vx, vy = humans[..., T.VX], humans[..., T.VY]
    dx = px[..., None, :] - px[..., :, None]  # [..., i, j]: j seen from i
    dy = py[..., None, :] - py[..., :, None]
    angle = torch.atan2(vy, vx)  # atan2(0, 0) = 0: a standing human
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = _rot(dx, dy, ca, sa)
    vxj, vyj = _rot(vx[..., None, :], vy[..., None, :], ca, sa)

    half = cell_num * cell_size / 2
    xi = torch.floor((x + half) / cell_size).to(torch.int32)
    yi = torch.floor((y + half) / cell_size).to(torch.int32)
    inside = (xi >= 0) & (xi < cell_num) & (yi >= 0) & (yi < cell_num)
    not_self = ~torch.eye(n, dtype=torch.bool, device=humans.device)
    valid = inside & not_self
    cell = torch.where(valid, yi * cell_num + xi, 0)
    num_cells = cell_num * cell_num
    onehot = ((cell[..., None] == torch.arange(num_cells,
                                               device=humans.device))
              & valid[..., None]).to(humans.dtype)  # [..., i, j, cells]
    occupancy = onehot.sum(-2)
    if om_channel_size == 1:
        return occupancy
    denom = torch.clamp(occupancy, min=1.0)
    mean_vx = (vxj[..., None] * onehot).sum(-2) / denom
    mean_vy = (vyj[..., None] * onehot).sum(-2) / denom
    maps = torch.stack([occupancy, mean_vx, mean_vy], -1)
    return maps.reshape(maps.shape[:-2] + (num_cells * 3,))


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
