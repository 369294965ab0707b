"""Social Force Model crowd dynamics (port of
``relationalgraphlearning_tpu/envs/social_force.py``).

Helbing & Molnár's model: goal attraction relaxes each velocity toward the
preferred one with time constant tau; pairwise repulsion
F = A·exp((r_ij - d_ij)/B)·n_ij weighted by a field of view (lambda); the
speed is clamped to the agent's maximum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class SFMParams(NamedTuple):
    tau: float = 0.5
    A: float = 2.0  # repulsion strength (m/s^2)
    B: float = 0.3  # repulsion range (m)
    lam: float = 0.5  # anisotropy factor (1 = isotropic)


def _safe_norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-12))


def centralized_sfm_step(positions: Tensor, velocities: Tensor,
                         radii: Tensor, pref_vels: Tensor,
                         max_speeds: Tensor, active: Tensor,
                         params: SFMParams, dt: float) -> Tensor:
    """One synchronous update of n agents: positions/velocities/pref_vels
    [..., n, 2], radii/max_speeds/active [..., n] -> new velocities
    [..., n, 2]."""
    diff = positions[..., None, :, :] - positions[..., :, None, :]  # i -> j
    dist = _safe_norm(diff)
    n_ij = -diff / dist[..., None]  # push i away from j
    r_ij = radii[..., :, None] + radii[..., None, :]
    mag = params.A * torch.exp((r_ij - dist) / params.B)

    # anisotropy: the angle between the walking direction e_i and -n_ij
    e_i = velocities / _safe_norm(velocities)[..., None]
    cos_phi = (e_i[..., :, None, :] * -n_ij).sum(-1)
    w = params.lam + (1.0 - params.lam) * 0.5 * (1.0 + cos_phi)

    n = positions.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    mask = (active[..., None, :] & ~eye).to(mag.dtype)
    f_rep = ((mag * w * mask)[..., None] * n_ij).sum(-2)

    f_goal = (pref_vels - velocities) / params.tau
    new_v = velocities + (f_goal + f_rep) * dt
    scale = torch.clamp(max_speeds / _safe_norm(new_v), max=1.0)
    new_v = new_v * scale[..., None]
    return torch.where(active[..., None], new_v, torch.zeros_like(new_v))
