"""The amortised mega-crowd rollout: kNN ORCA + SparseRGL values.

Port of the rollout in ``bench_extra.py::mega_crowd`` (its ``rebuild`` and
the chunk/body scans): ``MegaCrowdRollout`` runs a chunk's steps as one
captured CUDA graph on the card and as Python loops elsewhere. Each step
runs kNN ORCA for every agent and the 2-layer SparseRGL value net over the
crowd. Graph construction — spatial sort (block backend), grid kNN,
candidate windows and edge masks — runs once per ``rebuild_every`` steps and
is reused (stale) within the chunk, while ORCA reads the current positions.
With
``backend="block", packed=True`` the GNN aggregation runs the fused block
kernel, and with ``backend="pallas"`` the per-edge gather kernel over the
unsorted kNN graph: two launches a step either way (one per GCN layer).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, centralized_orca_step_knn)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import SparseValueNet
from relationalgraphlearning_tpu_torch.ops import block_graph, fused_gather
from relationalgraphlearning_tpu_torch.ops.fused_block import pack_emask
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.utils import profiling

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


@profiling.spanned("crowd.rebuild")
def rebuild(pos: Tensor, other: tuple, K: int, backend: str, block_B: int,
            block_C: int, packed: bool):
    """Sort the crowd spatially (block backend) and build the graphs the next
    chunk reuses. Every per-agent array in ``other`` rides the permutation.
    Returns (pos, other, cols_gnn, cols_orca, cand, emask, coverage)."""
    use_block = backend == "block"
    if use_block:
        with profiling.span("crowd.sort"):
            perm = block_graph.spatial_sort(pos)
            pos = pos[perm]
            other = tuple(a[perm] for a in other)
    with profiling.span("crowd.knn"):
        cols_gnn = knn_graph_auto(pos, K_GNN)
        cols_orca = knn_graph_auto(pos, K) if K != K_GNN else cols_gnn
    if use_block:
        with profiling.span("crowd.window"):
            cand, cov = block_graph.block_window(cols_gnn, block_B, block_C)
        with profiling.span("crowd.masks"):
            em = block_graph.block_masks(cols_gnn, cand)
            if packed:
                em = pack_emask(em)
    else:
        cand = em = None
        cov = torch.ones((), device=pos.device)
    return pos, other, cols_gnn, cols_orca, cand, em, cov


class MegaCrowdRollout:
    """The rollout's loop: for each chunk one ``rebuild`` and then
    ``rebuild_every`` (R) steps of kNN ORCA, the step and the value net.

    ``graphed`` (default: whether ``device`` is a card) captures a chunk's R
    steps once as one CUDA graph (``captured.Graphed``), as the reference
    runs its rollout as one jitted program; ``graphed=False`` runs them
    eagerly. The graph's static buffers hold pos, vel, goals, rad, vmax,
    act, cols_gnn, cols_orca, cand and em; its outputs are pos, vel and the
    chunk's R values. The rebuild stays eager (``knn_graph_grid`` builds a
    constant from host memory, which a capture refuses): each chunk copies
    its results, every per-agent array in the new order, into the static
    buffers, then replays. The graph is kept for later calls on crowds of
    the same size (another size raises: a runner serves one crowd size);
    ``graph.launches`` holds the kernel launches of one chunk's replay (2 a
    step on the block backend with ``packed`` and on the pallas backend).
    """

    def __init__(self, K: int = 10, backend: str = "gather",
                 block_B: int = 256, block_C: int = 640,
                 rebuild_every: int = 1, packed: bool = False,
                 net: Optional[SparseValueNet] = None, seed: int = 0,
                 device="cuda", graphed: Optional[bool] = None):
        self.K, self.backend, self.packed = K, backend, packed
        self.block_B, self.block_C = block_B, block_C
        self.rebuild_every = rebuild_every
        self.device = torch.device(device)
        self.graphed = (self.device.type == "cuda" if graphed is None
                        else graphed)
        if net is None:
            g = torch.Generator(device="cpu").manual_seed(seed + 1)
            net = SparseValueNet(GCNConfig(), backend=backend, generator=g)
        self.net = net.to(self.device).eval()
        self.params = ORCAParams()
        self.graph: Optional[Graphed] = None

    def chunk(self, pos: Tensor, vel: Tensor, goals: Tensor, rad: Tensor,
              vmax: Tensor, act: Tensor, cols_gnn: Tensor, cols_orca: Tensor,
              *block: Tensor):
        """R steps on one chunk's graphs (``block``: the block backend's
        cand and em) → (pos, vel, the per-step mean value [R])."""
        cand, em = block if block else (None, None)
        values = []
        for _ in range(self.rebuild_every):
            with profiling.device_phase("chunk.orca", pos.device):
                to = goals - pos
                d = torch.linalg.norm(to, dim=-1, keepdim=True)
                pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9),
                                   0.0)
                vel = centralized_orca_step_knn(pos, vel, rad, pref, vmax,
                                                act, self.params, self.K,
                                                cols=cols_orca)
                pos = pos + vel * DT
            with profiling.device_phase("chunk.value_net", pos.device):
                states = torch.cat([pos, vel, rad[:, None]], dim=-1)
                vals = self.net(states, cols_gnn, block_cand=cand,
                                block_emask=em)
                values.append(vals.mean())
        return pos, vel, torch.stack(values)

    @torch.no_grad()
    def __call__(self, pos: Tensor, steps: int):
        """Roll the crowd at ``pos`` [n, 2] toward the antipodes of its
        start for ``steps`` steps (a multiple of R). Returns ``((pos, vel),
        values, coverage)``: final positions and velocities (in the last
        rebuild's agent order), the per-step mean value [steps], and the
        minimum window coverage over the rebuilds."""
        if steps % self.rebuild_every:
            raise ValueError(f"steps={steps} is not a multiple of "
                             f"rebuild_every={self.rebuild_every}")
        dev = self.device
        pos = pos.to(device=dev, dtype=torch.float32)
        n = pos.shape[0]
        goals = -pos
        rad = torch.full((n,), 0.3, device=dev)
        vmax = torch.ones((n,), device=dev)
        act = torch.ones((n,), dtype=torch.bool, device=dev)
        vel = torch.zeros((n, 2), device=dev)
        values, covs = [], []
        for _ in range(steps // self.rebuild_every):
            pos, (vel, goals, rad, vmax, act), cols_gnn, cols_orca, cand, \
                em, cov = rebuild(pos, (vel, goals, rad, vmax, act), self.K,
                                  self.backend, self.block_B, self.block_C,
                                  self.packed)
            covs.append(cov)
            args = (pos, vel, goals, rad, vmax, act, cols_gnn, cols_orca,
                    *(() if cand is None else (cand, em)))
            if not self.graphed:
                pos, vel, vals = self.chunk(*args)
            else:
                if self.backend == "pallas":
                    # kernel #3 reads its ids unchecked, and a replay runs
                    # no Python: prove each rebuilt graph before it replays
                    fused_gather.check_ids(cols_gnn, n)
                if self.graph is None:
                    self.graph = Graphed(self.chunk, *args,
                                         name="crowd.chunk")
                with profiling.span("crowd.replay"):
                    pos, vel, vals = self.graph(*args)
                    vals = vals.clone()
            values.append(vals)
        if self.graphed:
            pos, vel = pos.clone(), vel.clone()
        return (pos, vel), torch.cat(values), torch.stack(covs).amin()


@torch.no_grad()
def mega_crowd_rollout(n: int = 10240, K: int = 10, steps: int = 16,
                       backend: str = "gather", block_B: int = 256,
                       block_C: int = 640, rebuild_every: int = 1,
                       packed: bool = False, side: Optional[float] = None,
                       pos: Optional[Tensor] = None,
                       net: Optional[SparseValueNet] = None, seed: int = 0,
                       device="cuda", graphed: Optional[bool] = None):
    """Roll a synthetic n-agent crowd toward the antipodes of its start.

    ``pos`` [n, 2] overrides the seeded start; ``net`` overrides the value
    net, whose weights are otherwise drawn from ``seed + 1``. ``graphed``
    as for ``MegaCrowdRollout`` (default: captured on the card). Returns
    ``((pos, vel), values, coverage)``: final positions and velocities (in
    the last rebuild's agent order), the per-step mean value [steps], and
    the minimum window coverage over the rebuilds.
    """
    if steps % rebuild_every:
        raise ValueError(f"steps={steps} is not a multiple of "
                         f"rebuild_every={rebuild_every}")
    if pos is None:
        pos = initial_crowd(n, side, seed, device)
    rollout = MegaCrowdRollout(K, backend, block_B, block_C, rebuild_every,
                               packed, net, seed, device, graphed)
    return rollout(pos, steps)
