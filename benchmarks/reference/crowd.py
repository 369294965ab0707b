"""The 10k-agent crowd in plain PyTorch: the kNN graphs of the spatial
hash, the block windows and masks the fused kernel reads, kNN ORCA and
SparseRGL's per-agent values by gathering each agent's K neighbours.

The kNN graph of a crowd this large is searched on a grid (the
configuration's ``knn``): square cells sized for ``max_per_cell``/2 agents
on average over the crowd's bounding box, each cell holding at most its
first ``max_per_cell`` agents by index; an agent's K nearest are taken
from the 3×3 cells around its own. Where a cell overflows, as in a jam,
that is not the exact kNN graph, and it is what the configuration states.

SparseRGL (the relational graph model of arXiv:1909.13165 over a kNN
graph): H = w_h(states); per layer q = H·Wa, each agent's scores against
its K neighbours' H, a softmax over them, the weighted sum of their H,
then relu(·W); the value network on each agent's H. Weights are keyed as
the benchmark makes them (``kernel`` [in, out], ``bias`` [out]).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import Tensor

from benchmarks.reference.orca import ORCAParams, orca_step_knn


def knn(pos: Tensor, k: int, max_per_cell: int) -> Tensor:
    """Each agent's k nearest among the others its grid search sees
    [n, k] (in ``pos``'s precision)."""
    n = pos.shape[0]
    span = pos.amax(0) - pos.amin(0)
    cell = torch.sqrt(torch.clamp(span[0] * span[1], min=1e-6)
                      * max_per_cell / (2.0 * n))
    ij = torch.floor((pos - pos.amin(0)) / cell).to(torch.int64)
    rows = int(ij[:, 0].max()) + 1
    cols = int(ij[:, 1].max()) + 1
    cid = ij[:, 0] * cols + ij[:, 1]
    # each cell's first max_per_cell agents by index, -1 where it has fewer
    order = torch.argsort(cid * n + torch.arange(n, device=pos.device))
    first = torch.searchsorted(cid[order], torch.arange(
        rows * cols, device=pos.device))
    slot = torch.arange(n, device=pos.device) - first[cid[order]]
    table = torch.full((rows * cols, max_per_cell), -1, dtype=torch.int64,
                       device=pos.device)
    keep = slot < max_per_cell
    table[cid[order][keep], slot[keep]] = order[keep]
    out, ids = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            i, j = ij[:, 0] + dx, ij[:, 1] + dy
            inside = (i >= 0) & (i < rows) & (j >= 0) & (j < cols)
            cand = table[torch.where(inside, i * cols + j, 0)]
            cand = torch.where(inside[:, None], cand, -1)
            d2 = ((pos[:, None, :] - pos[cand.clamp(min=0)]) ** 2).sum(-1)
            bad = (cand < 0) | (cand == torch.arange(n, device=pos.device)
                                [:, None])
            out.append(torch.where(bad, float("inf"), d2))
            ids.append(cand.clamp(min=0))
    pick = torch.topk(torch.cat(out, -1), k, dim=-1, largest=False).indices
    return torch.gather(torch.cat(ids, -1), 1, pick)


def graph_distances(pos: Tensor, cols: Tensor) -> Tensor:
    """The squared distances along a neighbour table, ascending [n, K]."""
    d2 = ((pos[:, None, :] - pos[cols]) ** 2).sum(-1)
    return torch.sort(d2, dim=-1).values


def windows(cols: Tensor, B: int, C: int) -> tuple[Tensor, Tensor, bool]:
    """Each block of B rows' window: the ascending distinct neighbour ids
    of its rows, padded with n to C slots [nb, C]; each row's mask over
    its window, packed 32 rows a word [nb, B/32, C] int32 (row w·32 + j in
    bit j of word w); and whether every block's ids fit in C slots."""
    n, K = cols.shape
    nb = n // B
    cand = torch.full((nb, C), n, dtype=torch.int64, device=cols.device)
    fits = True
    mask = torch.zeros((nb, B, C), dtype=torch.bool, device=cols.device)
    for blk in range(nb):
        ids = torch.unique(cols[blk * B:(blk + 1) * B])  # sorted
        fits &= ids.numel() <= C
        ids = ids[:C]
        cand[blk, :ids.numel()] = ids
        rows = cols[blk * B:(blk + 1) * B]
        mask[blk] = (rows[:, :, None] == cand[blk][None, None, :]).any(1)
    bits = mask.reshape(nb, B // 32, 32, C).to(torch.int64) << torch.arange(
        32, device=cols.device)[None, None, :, None]
    words = bits.sum(2)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return cand, words.to(torch.int32), fits


def _dense(x: Tensor, P: Mapping, name: str) -> Tensor:
    y = x @ P[name + "/kernel"]
    return y + P[name + "/bias"] if name + "/bias" in P else y


def _mlp(x: Tensor, P: Mapping, prefix: str, layers: int,
         last_relu: bool) -> Tensor:
    for i in range(layers):
        x = _dense(x, P, f"{prefix}/dense_{i}")
        if i < layers - 1 or last_relu:
            x = torch.relu(x)
    return x


def values(states: Tensor, cols: Tensor, P: Mapping, gcn_layers: int,
           wh_layers: int, value_layers: int) -> Tensor:
    """Each agent's value [n] from states [n, 5] over neighbours [n, K]."""
    H = _mlp(states, P, "graph_model/w_h", wh_layers, True)
    for i in range(gcn_layers):
        q = H @ P["graph_model/w_a/kernel"]
        nbr = H[cols]  # [n, K, d]
        attn = torch.softmax((q[:, None, :] * nbr).sum(-1), dim=-1)
        agg = (attn[..., None] * nbr).sum(1)
        H = torch.relu(agg @ P[f"graph_model/gcn_w{i + 1}/kernel"])
    return _mlp(H, P, "value_network", value_layers, False)[:, 0]


def chunk(pos: Tensor, vel: Tensor, goals: Tensor, rad: Tensor,
          vmax: Tensor, active: Tensor, cols_gnn: Tensor, cols_orca: Tensor,
          steps: int, dt: float, params: ORCAParams, P: Mapping,
          layers: tuple, orca_dtype=torch.float32
          ) -> tuple[Tensor, Tensor, Tensor]:
    """``steps`` steps on one chunk's graphs: each agent's ORCA velocity
    toward its goal against its neighbours (in ``orca_dtype``), the move,
    then every agent's value -> (pos, vel, the mean value of each step
    [steps])."""
    means = []
    for _ in range(steps):
        to = goals - pos
        d = torch.linalg.norm(to, dim=-1, keepdim=True)
        pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9), 0.0)
        low = [t.to(orca_dtype) for t in (pos, vel, rad, pref, vmax)]
        vel = orca_step_knn(*low, active, params, cols_orca).float()
        pos = pos + vel * dt
        states = torch.cat([pos, vel, rad[:, None]], dim=-1)
        means.append(values(states, cols_gnn, P, *layers).mean())
    return pos, vel, torch.stack(means)
