"""The amortised mega-crowd rollout: kNN ORCA + SparseRGL values.

Port of the rollout in ``bench_extra.py::mega_crowd`` (its ``rebuild`` and
the chunk/body scans), as Python loops. Each step runs kNN ORCA for every
agent and the 2-layer SparseRGL value net over the crowd. Graph
construction — spatial sort (block backend), grid kNN, candidate windows and
edge masks — runs once per ``rebuild_every`` steps and is reused (stale)
within the chunk, while ORCA reads the current positions. With
``backend="block", packed=True`` the GNN aggregation runs the fused block
kernel, and with ``backend="pallas"`` the per-edge gather kernel over the
unsorted kNN graph: two launches a step either way (one per GCN layer).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, centralized_orca_step_knn)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import SparseValueNet
from relationalgraphlearning_tpu_torch.ops import block_graph
from relationalgraphlearning_tpu_torch.ops.fused_block import pack_emask
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto

K_GNN = 16
DT = 0.25


def initial_crowd(n: int, side: Optional[float] = None, seed: int = 0,
                  device="cuda") -> Tensor:
    """Uniform positions in [-side, side]², side scaled to keep the
    reference's density (200 m at 10,240 agents)."""
    side = side or 200.0 * (n / 10240.0) ** 0.5
    g = torch.Generator(device="cpu").manual_seed(seed)
    pos = (torch.rand((n, 2), generator=g) * 2.0 - 1.0) * side
    return pos.to(device)


def rebuild(pos: Tensor, other: tuple, K: int, backend: str, block_B: int,
            block_C: int, packed: bool):
    """Sort the crowd spatially (block backend) and build the graphs the next
    chunk reuses. Every per-agent array in ``other`` rides the permutation.
    Returns (pos, other, cols_gnn, cols_orca, cand, emask, coverage)."""
    use_block = backend == "block"
    if use_block:
        perm = block_graph.spatial_sort(pos)
        pos = pos[perm]
        other = tuple(a[perm] for a in other)
    cols_gnn = knn_graph_auto(pos, K_GNN)
    cols_orca = knn_graph_auto(pos, K) if K != K_GNN else cols_gnn
    if use_block:
        cand, cov = block_graph.block_window(cols_gnn, block_B, block_C)
        em = block_graph.block_masks(cols_gnn, cand)
        if packed:
            em = pack_emask(em)
    else:
        cand = em = None
        cov = torch.ones((), device=pos.device)
    return pos, other, cols_gnn, cols_orca, cand, em, cov


@torch.no_grad()
def mega_crowd_rollout(n: int = 10240, K: int = 10, steps: int = 16,
                       backend: str = "gather", block_B: int = 256,
                       block_C: int = 640, rebuild_every: int = 1,
                       packed: bool = False, side: Optional[float] = None,
                       pos: Optional[Tensor] = None,
                       net: Optional[SparseValueNet] = None, seed: int = 0,
                       device="cuda"):
    """Roll a synthetic n-agent crowd toward the antipodes of its start.

    ``pos`` [n, 2] overrides the seeded start; ``net`` overrides the value
    net, whose weights are otherwise drawn from ``seed + 1``. Returns
    ``((pos, vel), values, coverage)``: final positions and velocities (in
    the last rebuild's agent order), the per-step mean value [steps], and the
    minimum window coverage over the rebuilds.
    """
    if steps % rebuild_every:
        raise ValueError(f"steps={steps} is not a multiple of "
                         f"rebuild_every={rebuild_every}")
    if pos is None:
        pos = initial_crowd(n, side, seed, device)
    pos = pos.to(device=device, dtype=torch.float32)
    n = pos.shape[0]
    goals = -pos
    rad = torch.full((n,), 0.3, device=device)
    vmax = torch.ones((n,), device=device)
    act = torch.ones((n,), dtype=torch.bool, device=device)
    vel = torch.zeros((n, 2), device=device)
    params = ORCAParams()
    if net is None:
        g = torch.Generator(device="cpu").manual_seed(seed + 1)
        net = SparseValueNet(GCNConfig(), backend=backend, generator=g)
    net = net.to(device).eval()

    values, covs = [], []
    for _ in range(steps // rebuild_every):
        pos, (vel, goals, rad, vmax, act), cols_gnn, cols_orca, cand, em, \
            cov = rebuild(pos, (vel, goals, rad, vmax, act), K, backend,
                          block_B, block_C, packed)
        covs.append(cov)
        for _ in range(rebuild_every):
            to = goals - pos
            d = torch.linalg.norm(to, dim=-1, keepdim=True)
            pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9), 0.0)
            vel = centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                            params, K, cols=cols_orca)
            pos = pos + vel * DT
            states = torch.cat([pos, vel, rad[:, None]], dim=-1)
            vals = net(states, cols_gnn, block_cand=cand, block_emask=em)
            values.append(vals.mean())
    return (pos, vel), torch.stack(values), torch.stack(covs).amin()
