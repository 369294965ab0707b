"""kNN graph construction, the fixed-K attention chain and the edge-list ops.

Port of ``relationalgraphlearning_tpu/ops/sparse.py``. The fixed-K chain ``sddmm_fixed_k`` → ``neighbor_softmax``
→ ``spmm_fixed_k`` is SparseRGL's gather backend and the exactness
cross-check of the block path.

Neighbour ranks must equal the reference's exactly, ties included. JAX's
``top_k`` puts the lower index first among equal values; a stable ascending
sort of the distances does the same, so ``_smallest_k`` uses that in place of
``torch.topk``, whose tie order is unspecified.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

_NEG = -1e30


def _smallest_k(d2: Tensor, k: int) -> Tensor:
    """Indices of the k smallest entries of each row, ties by lower index,
    as a contiguous [..., k] tensor (the kernels take contiguous ids)."""
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k].contiguous()


# --------------------------------------------------------------------- graphs
def knn_graph(positions: Tensor, k: int, valid: Optional[Tensor] = None,
              include_self: bool = False) -> Tensor:
    """k-nearest-neighbour graph: positions [n, 2] → cols [n, k].

    Invalid nodes are pushed to +inf distance; self excluded unless asked.
    O(n²) distance matrix.
    """
    n = positions.shape[0]
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    if not include_self:
        eye = torch.eye(n, dtype=torch.bool, device=positions.device)
        d2 = d2.masked_fill(eye, float("inf"))
    if valid is not None:
        d2 = d2.masked_fill(~valid[None, :], float("inf"))
    return _smallest_k(d2, k)


def knn_graph_grid(positions: Tensor, k: int, cell_size,
                   max_per_cell: int = 16,
                   include_self: bool = False,
                   valid: Optional[Tensor] = None) -> Tensor:
    """Spatial-hash k-NN: positions [n, 2] → cols [n, k], O(n·9C).

    Nodes are bucketed on a ``cell_size`` grid (sorted by cell id; cell
    ranges found by searchsorted), and each node's candidates are the up-to-
    ``max_per_cell`` nodes of its 3×3 cell neighbourhood. Equal to
    ``knn_graph`` when every true neighbour lies within one cell ring and no
    visited cell holds more than ``max_per_cell`` nodes.
    """
    n = positions.shape[0]
    dev = positions.device
    C = max_per_cell
    pmin = positions.amin(0)
    ij = torch.floor((positions - pmin) / cell_size).to(torch.int32)  # [n, 2]
    W = ij[:, 1].amax() + 2  # row stride; iy ≤ W-2 keeps ids unique
    cid = ij[:, 0] * W + ij[:, 1]  # [n]
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order].contiguous()

    offs = torch.tensor([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                        dtype=torch.int32, device=dev)
    nb = ij[:, None, :] + offs[None, :, :]  # [n, 9, 2]
    nb_cid = nb[..., 0] * W + nb[..., 1]  # [n, 9]

    start = torch.searchsorted(cid_sorted, nb_cid.reshape(-1)).reshape(n, 9)
    slot = torch.arange(C, device=dev)
    pos_in = start[..., None] + slot  # [n, 9, C]
    in_range = pos_in < n
    pos_cl = pos_in.clamp(0, n - 1)
    cand_ok = in_range & (cid_sorted[pos_cl] == nb_cid[..., None])
    cand = order[pos_cl]  # [n, 9, C] node ids

    d2 = ((positions[:, None, None, :] - positions[cand]) ** 2).sum(-1)
    d2 = d2.masked_fill(~cand_ok, float("inf"))
    if valid is not None:
        d2 = d2.masked_fill(~valid[cand], float("inf"))
    if not include_self:
        me = torch.arange(n, device=dev)[:, None, None]
        d2 = d2.masked_fill(cand == me, float("inf"))
    flat_idx = _smallest_k(d2.reshape(n, 9 * C), k)
    return torch.gather(cand.reshape(n, 9 * C), 1, flat_idx)


def knn_graph_auto(positions: Tensor, k: int, valid: Optional[Tensor] = None,
                   include_self: bool = False,
                   grid_threshold: int = 10_000,
                   max_per_cell: int = 32,
                   cell_size=None) -> Tensor:
    """Exact O(n²) ``knn_graph`` below ``grid_threshold`` nodes, spatial-hash
    ``knn_graph_grid`` above it. ``cell_size`` defaults to a density
    heuristic targeting ~``max_per_cell``/2 nodes per cell."""
    n = positions.shape[0]
    if n < grid_threshold:
        return knn_graph(positions, k, valid=valid, include_self=include_self)
    if cell_size is None:
        span = positions.amax(0) - positions.amin(0)
        area = torch.clamp(span[0] * span[1], min=1e-6)
        cell_size = torch.sqrt(area * max_per_cell / (2.0 * n))
    return knn_graph_grid(positions, k, cell_size, max_per_cell,
                          include_self=include_self, valid=valid)


# ------------------------------------------------------------ fixed-degree ops
def sddmm_fixed_k(q: Tensor, x: Tensor, cols: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Edge scores score[i,k] = q[i] · x[cols[i,k]]: q [n, d], x [n, d],
    cols [n, K] → [n, K]."""
    scores = torch.einsum("nd,nkd->nk", q, x[cols])
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG)
    return scores


def neighbor_softmax(scores: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Row softmax over the K neighbours; a fully masked row averages
    uniformly, as the reference's chain does."""
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG)
    return torch.softmax(scores, dim=-1)


def spmm_fixed_k(attn: Tensor, h: Tensor, cols: Tensor) -> Tensor:
    """out[i] = Σ_k attn[i,k] · h[cols[i,k]] — the GCN aggregation."""
    return torch.einsum("nk,nkd->nd", attn, h[cols])


# --------------------------------------------------------------- edge-list ops
def sddmm_edges(q: Tensor, x: Tensor, rows: Tensor, cols: Tensor,
                edge_valid: Optional[Tensor] = None) -> Tensor:
    """score[e] = q[rows[e]] · x[cols[e]] for an edge list [E]."""
    s = (q[rows] * x[cols]).sum(-1)
    if edge_valid is not None:
        s = s.masked_fill(~edge_valid, _NEG)
    return s


def segment_softmax(scores: Tensor, rows: Tensor, num_rows: int,
                    edge_valid: Optional[Tensor] = None) -> Tensor:
    """Softmax over edges sharing a source row. A row whose max is not
    finite (no edge at all) is shifted by 0, as in the reference."""
    if edge_valid is not None:
        scores = scores.masked_fill(~edge_valid, _NEG)
    row_max = torch.full((num_rows,), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    row_max = row_max.scatter_reduce(0, rows, scores, reduce="amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    e = torch.exp(scores - row_max[rows])
    if edge_valid is not None:
        e = e.masked_fill(~edge_valid, 0.0)
    denom = torch.zeros((num_rows,), dtype=e.dtype, device=e.device)
    denom = denom.index_add(0, rows, e)
    return e / torch.clamp(denom[rows], min=1e-20)


def spmm_edges(attn: Tensor, h: Tensor, rows: Tensor, cols: Tensor,
               num_rows: int) -> Tensor:
    """out[i] = Σ_{e: rows[e]=i} attn[e] · h[cols[e]]."""
    out = torch.zeros((num_rows, h.shape[1]), dtype=h.dtype, device=h.device)
    return out.index_add(0, rows, attn[:, None] * h[cols])


# ----------------------------------------------------------- layout conversion
def fixed_k_to_edges(cols: Tensor) -> Tuple[Tensor, Tensor]:
    """cols [n, k] → (rows [n·k], cols [n·k]), row-major."""
    n, k = cols.shape
    rows = torch.arange(n, device=cols.device).repeat_interleave(k)
    return rows, cols.reshape(-1)


def dense_adjacency(scores_or_attn: Tensor, cols: Tensor, n: int) -> Tensor:
    """Scatter fixed-K values back to a dense [n, n] matrix (testing);
    duplicate neighbours add up."""
    rows, flat = fixed_k_to_edges(cols)
    out = torch.zeros((n, n), dtype=scores_or_attn.dtype,
                      device=scores_or_attn.device)
    return out.index_put((rows, flat), scores_or_attn.reshape(-1),
                         accumulate=True)
