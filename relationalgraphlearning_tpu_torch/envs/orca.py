"""ORCA (Optimal Reciprocal Collision Avoidance), batched over agents.

Port of ``relationalgraphlearning_tpu/envs/orca.py`` (van den Berg, Guy, Lin,
Manocha — "Reciprocal n-body collision avoidance", ISRR 2009): half-plane
construction, the incremental 2-D linear program (linearProgram1/2) and the
infeasible fallback (linearProgram3), with the reference's masked fixed-trip
loops over the M ≤ 10 lines. Every function takes leading batch dimensions
(agents) in place of the reference's ``vmap``.

The reference runs the 1-D LP of line ``i`` inside the 2-D LP's loop, but
that LP reads neither the running result nor anything else the loop
changes; nor do linearProgram3's projected lines and their 2-D LP, which
depend on ``i`` only. So ``_linear_program1_all`` solves every line's 1-D LP
at once ([..., M, M] pairs, its reductions are exact min/max/any), the
projected problems of linearProgram3 are solved batched up front, and what
stays sequential is M-step ``where`` chains. The arithmetic of each value is
the reference's.

That is the plain version, ``orca_velocity_plain``, which
``orca_velocity`` runs for CPU tensors. For CUDA tensors ``orca_velocity``
is one launch of a hand-written kernel (``ops/orca.py``, one thread an
agent) that repeats the plain version's float32 arithmetic operation by
operation, or a raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import orca as orca_kernel
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto

_EPS = 1e-5


class ORCAParams(NamedTuple):
    neighbor_dist: float = 10.0
    time_horizon: float = 5.0
    time_step: float = 0.25
    safety_space: float = 0.0


def _det(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm_sq(a: Tensor) -> Tensor:
    return _dot(a, a)


def orca_lines(p_i: Tensor, v_i: Tensor, r_i: Tensor,
               p_j: Tensor, v_j: Tensor, r_j: Tensor,
               valid: Tensor, params: ORCAParams
               ) -> tuple[Tensor, Tensor, Tensor]:
    """ORCA half-plane lines of each agent against its M neighbours.

    p_i/v_i [..., 2], r_i [...]; p_j/v_j [..., M, 2], r_j/valid [..., M].
    Returns (points [..., M, 2], directions [..., M, 2], valid [..., M]); the
    feasible half-plane of a line is {v : det(direction, point - v) <= 0}.
    """
    inv_th = 1.0 / params.time_horizon
    inv_dt = 1.0 / params.time_step

    rel_pos = p_j - p_i[..., None, :]
    rel_vel = v_i[..., None, :] - v_j
    dist_sq = _norm_sq(rel_pos)
    comb_r = r_i[..., None] + r_j
    comb_r_sq = comb_r * comb_r
    colliding = dist_sq <= comb_r_sq

    # non-colliding: project on the VO cone truncated at time_horizon
    w = rel_vel - inv_th * rel_pos
    w_len_sq = _norm_sq(w)
    dot1 = _dot(w, rel_pos)
    on_cutoff = (dot1 < 0.0) & (dot1 * dot1 > comb_r_sq * w_len_sq)

    w_len = torch.sqrt(torch.clamp(w_len_sq, min=1e-20))
    unit_w = w / w_len[..., None]
    dir_cut = torch.stack([unit_w[..., 1], -unit_w[..., 0]], dim=-1)
    u_cut = (comb_r * inv_th - w_len)[..., None] * unit_w

    leg = torch.sqrt(torch.clamp(dist_sq - comb_r_sq, min=1e-20))
    left_side = _det(rel_pos, w) > 0.0
    rx, ry = rel_pos[..., 0], rel_pos[..., 1]
    dsq = torch.clamp(dist_sq, min=1e-20)[..., None]
    dir_left = torch.stack([rx * leg - ry * comb_r,
                            rx * comb_r + ry * leg], dim=-1) / dsq
    dir_right = -torch.stack([rx * leg + ry * comb_r,
                              -rx * comb_r + ry * leg], dim=-1) / dsq
    dir_leg = torch.where(left_side[..., None], dir_left, dir_right)
    dot2 = _dot(rel_vel, dir_leg)
    u_leg = dot2[..., None] * dir_leg - rel_vel

    dir_nc = torch.where(on_cutoff[..., None], dir_cut, dir_leg)
    u_nc = torch.where(on_cutoff[..., None], u_cut, u_leg)

    # colliding: cutoff at time_step
    w_c = rel_vel - inv_dt * rel_pos
    w_c_len = torch.sqrt(torch.clamp(_norm_sq(w_c), min=1e-20))
    unit_w_c = w_c / w_c_len[..., None]
    dir_col = torch.stack([unit_w_c[..., 1], -unit_w_c[..., 0]], dim=-1)
    u_col = (comb_r * inv_dt - w_c_len)[..., None] * unit_w_c

    direction = torch.where(colliding[..., None], dir_col, dir_nc)
    u = torch.where(colliding[..., None], u_col, u_nc)
    point = v_i[..., None, :] + 0.5 * u

    in_range = dist_sq < params.neighbor_dist ** 2
    return point, direction, valid & in_range


def _lower_lines(M: int, device) -> Tensor:
    """[M, M] bool: j < i for row i, column j."""
    idx = torch.arange(M, device=device)
    return idx[None, :] < idx[:, None]


def _linear_program1_all(pts: Tensor, dirs: Tensor, valid: Tensor,
                         radius: Tensor, opt_vel: Tensor,
                         direction_opt: bool) -> tuple[Tensor, Tensor]:
    """1-D LP along every line i subject to the disc and the valid lines
    j < i, for all i at once.

    pts/dirs [..., M, 2], valid [..., M], radius [...], opt_vel [..., 2].
    Returns (feasible [..., M], result [..., M, 2]).
    """
    M = pts.shape[-2]
    dot_product = _dot(pts, dirs)
    discriminant = (dot_product * dot_product + (radius * radius)[..., None]
                    - _dot(pts, pts))
    feasible = discriminant >= 0.0
    sqrt_disc = torch.sqrt(torch.clamp(discriminant, min=0.0))
    t_left = -dot_product - sqrt_disc
    t_right = -dot_product + sqrt_disc

    dr, pt = dirs[..., :, None, :], pts[..., :, None, :]     # line i
    dj, pj = dirs[..., None, :, :], pts[..., None, :, :]     # line j
    denom = _det(dr, dj)  # [..., M, M]
    numer = _det(dj, pt - pj)
    use = _lower_lines(M, pts.device) & valid[..., None, :]
    parallel = denom.abs() <= _EPS
    # parallel & numerator < 0 → infeasible; parallel & numer >= 0 → no-op
    feasible = feasible & ~(use & parallel & (numer < 0.0)).any(-1)
    t = numer / torch.where(parallel, 1.0, denom)
    upd = use & ~parallel
    t_right = torch.minimum(t_right, torch.where(
        upd & (denom >= 0.0), t, float("inf")).amin(-1))
    t_left = torch.maximum(t_left, torch.where(
        upd & (denom < 0.0), t, float("-inf")).amax(-1))
    feasible = feasible & (t_left <= t_right)

    opt = opt_vel[..., None, :]
    if direction_opt:
        t = torch.where(_dot(opt, dirs) > 0.0, t_right, t_left)
    else:
        t = torch.clamp(_dot(dirs, opt - pts), t_left, t_right)
    return feasible, pts + t[..., None] * dirs


def _linear_program2(pts: Tensor, dirs: Tensor, valid: Tensor,
                     radius: Tensor, opt_vel: Tensor,
                     direction_opt: bool) -> tuple[Tensor, Tensor]:
    """Incremental 2-D LP. Returns (result [..., 2], fail_line [...] — M if
    feasible)."""
    M = pts.shape[-2]
    if direction_opt:
        result = opt_vel * radius[..., None]
    else:
        speed_sq = _norm_sq(opt_vel)
        scaled = (opt_vel / torch.sqrt(torch.clamp(speed_sq, min=1e-20))
                  [..., None] * radius[..., None])
        result = torch.where((speed_sq > radius * radius)[..., None],
                             scaled, opt_vel)
    feasible, line_result = _linear_program1_all(
        pts, dirs, valid, radius, opt_vel, direction_opt)
    fail = torch.full(pts.shape[:-2], M, dtype=torch.int64,
                      device=pts.device)
    for i in range(M):
        ok = fail >= M  # still feasible so far
        violated = (valid[..., i] & ok
                    & (_det(dirs[..., i, :], pts[..., i, :] - result) > 0.0))
        result = torch.where((violated & feasible[..., i])[..., None],
                             line_result[..., i, :], result)
        fail = torch.where(violated & ~feasible[..., i], i, fail)
    return result, fail


def _linear_program3(pts: Tensor, dirs: Tensor, valid: Tensor,
                     begin_line: Tensor, radius: Tensor,
                     result: Tensor) -> Tensor:
    """Infeasible fallback: minimise the maximum half-plane penetration,
    RVO2's linearProgram3 with no static obstacle lines."""
    M = pts.shape[-2]
    di, pi = dirs[..., :, None, :], pts[..., :, None, :]     # line i
    dj, pj = dirs[..., None, :, :], pts[..., None, :, :]     # line j
    denom = _det(di, dj)  # [..., M, M]
    parallel = denom.abs() <= _EPS
    same_dir = _dot(di, dj) > 0.0
    # parallel & same direction → skip line j entirely
    use_j = (_lower_lines(M, pts.device) & valid[..., None, :]
             & ~(parallel & same_dir))
    pt_parallel = 0.5 * (pi + pj)  # parallel, opposite direction
    tproj = _det(dj, pi - pj) / torch.where(parallel, 1.0, denom)
    pt_general = pi + tproj[..., None] * di
    proj_pts = torch.where(parallel[..., None], pt_parallel, pt_general)
    dgap = dj - di
    dlen = torch.sqrt(torch.clamp(_norm_sq(dgap), min=1e-20))
    proj_dirs = dgap / dlen[..., None]
    opt_dir = torch.stack([-dirs[..., 1], dirs[..., 0]], dim=-1)
    radius_i = radius[..., None].expand(*radius.shape, M)
    proj_result, proj_fail = _linear_program2(
        proj_pts, proj_dirs, use_j, radius_i, opt_dir, True)

    distance = torch.zeros(pts.shape[:-2], dtype=pts.dtype, device=pts.device)
    for i in range(M):
        pen = _det(dirs[..., i, :], pts[..., i, :] - result)
        act = valid[..., i] & (i >= begin_line) & (pen > distance)
        # keep the old result if the projected LP itself failed (numerical)
        new_result = torch.where((proj_fail[..., i] >= M)[..., None],
                                 proj_result[..., i, :], result)
        result = torch.where(act[..., None], new_result, result)
        distance = torch.where(
            act, _det(dirs[..., i, :], pts[..., i, :] - result), distance)
    return result


def orca_velocity(p_i: Tensor, v_i: Tensor, r_i: Tensor, pref_vel: Tensor,
                  max_speed: Tensor, p_j: Tensor, v_j: Tensor, r_j: Tensor,
                  valid: Tensor, params: ORCAParams) -> Tensor:
    """New velocity of each agent given its M (masked) neighbours:
    p_i/v_i/pref_vel [..., 2], r_i/max_speed [...], p_j/v_j [..., M, 2],
    r_j/valid [..., M] → [..., 2]. CUDA tensors: the kernel
    (``ops/orca.py``); CPU tensors: ``orca_velocity_plain``."""
    if p_i.is_cuda:
        return orca_kernel.orca_velocity(p_i, v_i, r_i, pref_vel, max_speed,
                                         p_j, v_j, r_j, valid, params)
    return orca_velocity_plain(p_i, v_i, r_i, pref_vel, max_speed, p_j, v_j,
                               r_j, valid, params)


def orca_velocity_plain(p_i: Tensor, v_i: Tensor, r_i: Tensor,
                        pref_vel: Tensor, max_speed: Tensor, p_j: Tensor,
                        v_j: Tensor, r_j: Tensor, valid: Tensor,
                        params: ORCAParams) -> Tensor:
    """``orca_velocity`` as masked tensor operations, on any device."""
    pts, dirs, line_valid = orca_lines(
        p_i, v_i, r_i + params.safety_space,
        p_j, v_j, r_j + params.safety_space, valid, params)
    result, fail = _linear_program2(
        pts, dirs, line_valid, max_speed, pref_vel, False)
    M = pts.shape[-2]
    fallback = _linear_program3(pts, dirs, line_valid, fail, max_speed,
                                result)
    return torch.where((fail < M)[..., None], fallback, result)


def centralized_orca_step(positions: Tensor, velocities: Tensor,
                          radii: Tensor, pref_vels: Tensor,
                          max_speeds: Tensor, active: Tensor,
                          params: ORCAParams) -> Tensor:
    """One synchronous ORCA update of n agents against all others.

    positions/velocities/pref_vels [..., n, 2]; radii/max_speeds/active
    [..., n], with any leading (env) dimensions. Inactive agents keep zero
    velocity and are invisible to others.
    """
    n = positions.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    valid = active[..., None, :] & ~eye
    lead = positions.shape[:-2]
    new_v = orca_velocity(
        positions, velocities, radii, pref_vels, max_speeds,
        positions[..., None, :, :].expand(*lead, n, n, 2),
        velocities[..., None, :, :].expand(*lead, n, n, 2),
        radii[..., None, :].expand(*lead, n, n), valid, params)
    return torch.where(active[..., None], new_v, torch.zeros_like(new_v))


def centralized_orca_step_knn(positions: Tensor, velocities: Tensor,
                              radii: Tensor, pref_vels: Tensor,
                              max_speeds: Tensor, active: Tensor,
                              params: ORCAParams, max_neighbors: int = 10,
                              cols: Optional[Tensor] = None) -> Tensor:
    """Large-crowd variant: each agent builds ORCA lines only against its
    ``max_neighbors`` nearest agents (RVO2's ``maxNeighbors`` semantics).

    Pass ``cols`` [n, K] to reuse a precomputed neighbour graph (the
    amortised-rebuild path); avoidance still reads the neighbours' current
    positions and velocities.
    """
    if cols is None:
        cols = knn_graph_auto(positions, max_neighbors, valid=active)
    n = positions.shape[0]
    me = torch.arange(n, device=positions.device)[:, None]
    valid = active[cols] & (cols != me)
    new_v = orca_velocity(
        positions, velocities, radii, pref_vels, max_speeds,
        positions[cols], velocities[cols], radii[cols], valid, params)
    return torch.where(active[..., None], new_v, torch.zeros_like(new_v))
