"""Node-partitioned sparse graph aggregation over D ranks.

Port of ``relationalgraphlearning_tpu/parallel/graph_partition.py``. Nodes
are block-partitioned over the ranks (rank s owns rows [s·n_loc,
(s+1)·n_loc)); ``cols`` keep GLOBAL ids. Each per-rank function takes a
``comm`` (``parallel/comm.py``) and this rank's rows, as its JAX
counterpart does inside ``shard_map``:

- **all-gather**: gather the node tables, then the local rows' fixed-K
  chain (``ops/sparse.py``);
- **ring**: D − 1 ``ppermute`` hops circulate the feature blocks; each hop
  folds the block in flight into a running online softmax (max m,
  normalizer s, weighted sum acc), so no rank holds the whole table;
- **block halo**: on spatially sorted rows, one halo exchange (two
  ``ppermute``s) makes every candidate of the rank's blocks local, and the
  windowed block attention runs on local tiles: a bool mask runs the plain
  block math, a packed int32 mask kernel #1 (keys are the values, one
  exchange) or #2 (a separate value table, two exchanges) of
  ``ops/fused_block.py``, with the exchanged table as the kernel's table
  and the local candidate ids as its ``cand``.

``partitioned_sparse_rgl`` and ``partitioned_block_rgl`` are SparseRGL's
forward through these on a ``Mesh``; ``sparse_rgl_rank`` and
``block_rgl_rank`` are their per-rank bodies, which a
``distributed.launch`` runs as processes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.models.sparse_rgl import SparseRGL
from relationalgraphlearning_tpu_torch.ops import sparse
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    fused_block_attention_packed, fused_block_attention_packed_shared)
from relationalgraphlearning_tpu_torch.parallel.mesh import ROW, Mesh

_NEG = -1e30


# ---------------------------------------------------------------- primitives
def _local_scores(q: Tensor, x_blk: Tensor, cols: Tensor, blk_start: int,
                  blk_size: int):
    """Scores of the edges whose source col lands in the current block:
    q [n_loc, d], x_blk [blk, d], cols [n_loc, K] global → (scores
    [n_loc, K] masked to the block, local ids [n_loc, K], in-block)."""
    in_blk = (cols >= blk_start) & (cols < blk_start + blk_size)
    local = torch.clamp(cols - blk_start, 0, blk_size - 1)
    s = torch.einsum("nd,nkd->nk", q, x_blk[local])
    return s.masked_fill(~in_blk, _NEG), local, in_blk


def ring_neighbor_attention(comm, q: Tensor, x: Tensor, v: Tensor,
                            cols: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Per rank: the online softmax over ring-circulated blocks,
        m' = max(m, m_blk); s' = s·e^{m−m'} + s_blk·e^{m_blk−m'};
        acc' = acc·e^{m−m'} + acc_blk·e^{m_blk−m'}.
    When ``v is x`` one ``ppermute`` a hop carries both roles."""
    D, me = comm.size, comm.rank
    n_loc = x.shape[0]
    if mask is None:
        mask = torch.ones(cols.shape, dtype=torch.bool, device=q.device)

    def fold(carry, x_blk, v_blk, owner):
        m, s, acc = carry
        scores, local, in_blk = _local_scores(q, x_blk, cols,
                                              owner * n_loc, n_loc)
        scores = scores.masked_fill(~mask, _NEG)
        m_blk = scores.amax(dim=-1)
        m_new = torch.maximum(m, m_blk)
        # guard: exp(-inf - -inf)
        e_old = torch.exp(torch.where(m > _NEG / 2, m - m_new, _NEG))
        w = torch.exp(scores - m_new[:, None])
        w = torch.where(in_blk & mask, w, 0.0)
        s_blk = w.sum(dim=-1)
        acc_blk = torch.einsum("nk,nkd->nd", w, v_blk[local])
        return m_new, s * e_old + s_blk, acc * e_old[:, None] + acc_blk

    rows = q.shape[0]
    carry = (torch.full((rows,), _NEG, device=q.device),
             torch.zeros((rows,), device=q.device),
             torch.zeros((rows, v.shape[-1]), device=q.device))
    carry = fold(carry, x, v, me)
    same = v is x
    x_blk, v_blk = x, v
    for step in range(1, D):
        # after `step` hops this rank holds the block of rank me - step
        x_blk = comm.ppermute(x_blk, +1)
        v_blk = x_blk if same else comm.ppermute(v_blk, +1)
        carry = fold(carry, x_blk, v_blk, (me - step) % D)
    _, s, acc = carry
    return acc / torch.clamp(s, min=1e-20)[:, None]


def allgather_neighbor_attention(comm, q: Tensor, x: Tensor, v: Tensor,
                                 cols: Tensor,
                                 mask: Optional[Tensor]) -> Tensor:
    """Per rank: all-gather the node tables, compute the local rows."""
    x_all = comm.all_gather(x)
    v_all = x_all if v is x else comm.all_gather(v)
    scores = sparse.sddmm_fixed_k(q, x_all, cols, mask)
    attn = sparse.neighbor_softmax(scores, mask)
    return sparse.spmm_fixed_k(attn, v_all, cols)


# ------------------------------------------------------- the block (halo) path
def halo_exchange(comm, x, halo: int):
    """[n_loc, ...] rows → [n_loc + 2·halo, ...]: the previous rank's tail
    and the next rank's head appended, by two ``ppermute``s (O(halo·d)
    bytes, not the all-gather's O(n·d)). ``x`` may be a tuple of tensors
    with the same rows, exchanged together.

    The ring wraps at the ends (rank 0 receives rank D−1's tail); callers
    mask the candidates out of range, so wrapped rows are never read.
    ``halo`` must be positive: ``x[-0:]`` would be the whole shard.
    """
    if halo <= 0:
        raise ValueError(f"halo_exchange needs halo > 0, got {halo}")
    single = isinstance(x, Tensor)
    xs = (x,) if single else tuple(x)
    left = comm.ppermute(tuple(t[-halo:] for t in xs), +1)   # from me - 1
    right = comm.ppermute(tuple(t[:halo] for t in xs), -1)   # from me + 1
    out = tuple(torch.cat([lt, t, rt], dim=0)
                for lt, t, rt in zip(left, xs, right))
    return out[0] if single else out


def halo_reach(cand: Tensor, B: int, n_loc: int) -> int:
    """The farthest any block's candidate reaches outside its rank's rows:
    the least exact halo. ``cand`` [nb, C] global ids (sentinel n for empty
    slots), B rows a block, n_loc rows a rank. Host numpy, as the
    reference's."""
    cnp = cand.cpu().numpy()
    nb, _ = cnp.shape
    n = nb * B
    shard = (np.arange(nb) * B) // n_loc
    start = shard * n_loc
    end = start + n_loc
    real = cnp < n  # sentinel slots don't constrain the halo
    lo = np.where(real, start[:, None] - cnp, 0).max(initial=0)
    hi = np.where(real, cnp + 1 - end[:, None], 0).max(initial=0)
    return int(max(lo, hi, 0))


def halo_kernel_args(comm, q: Tensor, x: Tensor, v: Tensor, cand: Tensor,
                     emask: Tensor, halo: int):
    """What ``block_halo_attention`` hands the block attention on this rank:
    (qb [nb_loc, B, dq], x_ext, v_ext [n_loc + 2·halo, ·] the exchanged
    tables (``v_ext is x_ext`` when ``v is x``), localc [nb_loc, C] the
    local candidate ids clipped into the table, mask: ``emask`` with the
    slots outside the table cleared, bool or packed int32 as given)."""
    me = comm.rank
    n_loc, dq = x.shape
    nb_loc, _ = cand.shape
    B = n_loc // nb_loc
    if halo > n_loc:
        # a ring of one hop cannot reach past the adjacent rank; halo ==
        # n_loc is the full-adjacent-slab exchange (partitioned_build.py)
        raise ValueError(
            f"halo={halo} > rows/shard={n_loc}: candidate reach exceeds "
            "the adjacent shard; use fewer/larger shards for this graph")
    same = v is x  # one exchange, one table when keys are the values
    if halo > 0:
        x_ext = halo_exchange(comm, x, halo)
        v_ext = x_ext if same else halo_exchange(comm, v, halo)
    else:  # halo_reach == 0: every candidate is local already
        x_ext, v_ext = x, v
    n_ext = n_loc + 2 * halo
    local = cand - me * n_loc + halo                  # [nb_loc, C]
    ok = (local >= 0) & (local < n_ext)               # out of halo/sentinel
    localc = torch.clamp(local, 0, n_ext - 1)
    qb = q.reshape(nb_loc, B, dq).contiguous()
    if emask.dtype == torch.int32:
        keep = torch.where(ok, -1, 0).to(torch.int32)  # all 32 bits or none
        return qb, x_ext, v_ext, localc, emask & keep[:, None, :]
    return qb, x_ext, v_ext, localc, emask & ok[:, None, :]


def block_halo_attention(comm, q: Tensor, x: Tensor, v: Tensor,
                         cand: Tensor, emask: Tensor, halo: int) -> Tensor:
    """Per rank: the windowed block attention on a node-partitioned crowd.

    q/x/v [n_loc, d] (this rank's spatially sorted rows), cand [nb_loc, C]
    GLOBAL candidate ids of the rank's blocks, emask [nb_loc, B, C] bool or
    packed [nb_loc, B//32, C] int32 (``fused_block.pack_emask``). After one
    halo exchange every candidate row is local (exact iff ``halo ≥
    halo_reach(cand, B, n_loc)``). A packed mask runs kernel #1 when ``v is
    x`` and #2 otherwise, on the exchanged table with the local candidate
    ids (``halo_kernel_args``); slots outside the table have their mask
    bits cleared, as the reference does, and the kernel clips their ids.
    """
    n_loc = x.shape[0]
    qb, x_ext, v_ext, localc, m = halo_kernel_args(comm, q, x, v, cand,
                                                   emask, halo)
    if m.dtype == torch.int32:
        if v_ext is x_ext:
            out = fused_block_attention_packed_shared(qb, x_ext, localc, m)
        else:
            out = fused_block_attention_packed(qb, x_ext, v_ext, localc, m)
        return out.reshape(n_loc, -1)

    xg, vg = x_ext[localc], v_ext[localc]
    scores = torch.einsum("nbd,ncd->nbc", qb, xg).masked_fill(~m, _NEG)
    attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
    return torch.einsum("nbc,ncd->nbd", attn, vg).reshape(n_loc, -1)


# ------------------------------------------------------------ full forwards
def _gcn_layers(model: SparseRGL, H: Tensor, aggregate) -> Tensor:
    """SparseRGL's layers with the weight applied after the aggregation
    (exact by linearity): values are the keys, one table a layer."""
    for layer in model.gcn_layers:
        q = model.w_a(H)
        H_next = torch.relu(layer(aggregate(q, H)))
        if model.cfg.skip_connection and H_next.shape == H.shape:
            H_next = H_next + H
        H = H_next
    return H


def block_rgl_rank(comm, model: SparseRGL, halo: int, states: Tensor,
                   cand: Tensor, emask: Tensor) -> Tensor:
    """Per rank: SparseRGL's block forward on this rank's rows."""
    comm = comm.axis("data")  # a model axis replicates the forward
    return _gcn_layers(model, model.w_h(states), lambda q, H: (
        block_halo_attention(comm, q, H, H, cand, emask, halo)))


def partitioned_block_rgl(model: SparseRGL, states: Tensor, cand: Tensor,
                          emask: Tensor, mesh: Mesh, halo: int) -> Tensor:
    """SparseRGL's forward through the block backend with the nodes
    partitioned over ``mesh``'s data axis and halo-exchanged candidate
    features.

    ``states`` [n, 5] spatially sorted (``block_graph.spatial_sort``), n
    divisible by D·B; ``cand``/``emask`` from ``block_window`` /
    ``block_masks`` (optionally ``pack_emask``-packed) on the GLOBAL graph;
    ``halo`` ≥ ``halo_reach(cand, B, n/D)``.
    """
    n, D, nb = states.shape[0], mesh.data, cand.shape[0]
    if n % (D * (n // nb)) or nb % D:
        raise ValueError(f"n={n} rows in nb={nb} blocks do not split over "
                         f"D={D} ranks")
    return mesh.run(block_rgl_rank, replicated=(model, halo),
                    row_sharded=(states, cand, emask), out_specs=ROW)


def sparse_rgl_rank(comm, model: SparseRGL, method: str, states: Tensor,
                    cols: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Per rank: SparseRGL's gather forward on this rank's rows, the
    aggregation by ring or all-gather."""
    agg = (ring_neighbor_attention if method == "ring"
           else allgather_neighbor_attention)
    comm = comm.axis("data")  # a model axis replicates the forward
    return _gcn_layers(model, model.w_h(states),
                       lambda q, H: agg(comm, q, H, H, cols, mask))


def partitioned_sparse_rgl(model: SparseRGL, states: Tensor, cols: Tensor,
                           mesh: Mesh, mask: Optional[Tensor] = None,
                           method: str = "ring") -> Tensor:
    """SparseRGL's forward with the nodes partitioned over ``mesh``'s data
    axis: states [n, 5] and cols [n, K] (global ids) split by rows; the
    dense applies are row-local and only the aggregation communicates.

    n is padded up to a multiple of D; padded rows carry an all-False edge
    mask (the softmax guard zeroes them) and are sliced off after.
    """
    if method not in ("ring", "allgather"):
        raise ValueError(f"method {method!r} not in ('ring', 'allgather')")
    n, K = cols.shape
    pad = (-n) % mesh.data
    if pad:
        if mask is None:
            mask = torch.ones((n, K), dtype=torch.bool, device=cols.device)
        states = torch.cat([states, states.new_zeros((pad,) +
                                                     states.shape[1:])])
        cols = torch.cat([cols, cols.new_zeros((pad, K))])
        mask = torch.cat([mask, mask.new_zeros((pad, K))])
    out = mesh.run(sparse_rgl_rank, replicated=(model, method),
                   row_sharded=(states, cols, mask), out_specs=ROW)
    return out[:n] if pad else out
