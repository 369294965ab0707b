"""Windowed dense neighbour attention: spatial sort, candidate windows, masks.

Port of ``relationalgraphlearning_tpu/ops/block_graph.py``. Nodes are sorted into grid-cell order; each block of ``B`` sorted
rows gets a deduplicated, ascending candidate list of ``C`` node ids (the
union of its rows' kNN neighbours); ``block_masks`` marks each row's true
edges inside that window. The masked dense softmax over the window then
equals the per-row softmax over the K neighbours whenever ``coverage`` is 1.

``block_window_aligned`` builds the same windows out of ``align``-row slices
(``gather_aligned`` fetches them). All integer artifacts (``perm``,
``cand``, ``starts``, ``emask``) are bit-equal to the
reference's; ``tests/test_torch_block_graph.py`` holds them so.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops.fused_block import pack_emask
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto

_NEG = -1e30


def spatial_sort(positions: Tensor, cell_size=None) -> Tensor:
    """Permutation putting nodes in grid-cell (row-major) order.

    ``positions[perm]`` is spatially blocked; apply the same permutation to
    every per-node array before using the block ops.
    """
    n = positions.shape[0]
    if cell_size is None:
        span = positions.amax(0) - positions.amin(0)
        area = torch.clamp(span[0] * span[1], min=1e-6)
        cell_size = torch.sqrt(area * 64.0 / n)  # ~64 nodes per cell
    pmin = positions.amin(0)
    ij = torch.floor((positions - pmin) / cell_size).to(torch.int32)
    W = ij[:, 1].amax() + 2
    return torch.argsort(ij[:, 0] * W + ij[:, 1], stable=True)


def block_window(cols: Tensor, block_size: int, window: int,
                 sentinel: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Per-block deduplicated candidate lists.

    cols [n, K] (n divisible by ``block_size``) → ``cand [nb, window]``
    sorted ascending, padded with the sentinel (default ``n``); and
    ``coverage`` (0-d float tensor), the fraction of edges whose endpoint
    made it into its block's window (1.0 = the dense path is exact).
    """
    n, K = cols.shape
    if n % block_size:
        raise ValueError(f"n={n} is not a multiple of block_size={block_size}")
    if sentinel is None:
        sentinel = n
    nb = n // block_size
    ids = torch.sort(cols.reshape(nb, block_size * K), dim=-1).values
    first = torch.cat([torch.ones((nb, 1), dtype=torch.bool,
                                  device=cols.device),
                       ids[:, 1:] != ids[:, :-1]], dim=-1)
    slot = torch.cumsum(first, dim=-1) - 1  # [nb, BK]
    ok = first & (slot < window)
    dump = torch.where(ok, slot, window)  # overflow + duplicates → dump slot
    buf = torch.full((nb, window + 1), sentinel, dtype=cols.dtype,
                     device=cols.device)
    # only the dump slot receives several writes, and it is cut off below
    cand = buf.scatter(1, dump, ids)[:, :window].contiguous()
    # an edge is covered iff its endpoint id equals the candidate at its
    # searchsorted slot
    sl = torch.searchsorted(cand, ids).clamp(0, window - 1)
    coverage = (torch.gather(cand, 1, sl) == ids).float().mean()
    return cand, coverage


def block_window_aligned(cols: Tensor, block_size: int, window: int,
                         align: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Aligned-slice candidate windows: candidates are ``align``-row slice
    starts instead of single rows.

    Returns ``(starts [nb, S], cand [nb, S·align], coverage)`` with
    S = window // align: ``starts`` sorted ascending in units of ``align``
    rows (sentinel n // align), ``cand`` the expanded row ids (sorted; feed
    to ``block_masks``/``pack_emask`` unchanged), ``coverage`` the fraction
    of edges whose target's slice made the window.
    """
    n, K = cols.shape
    if n % block_size or window % align:
        raise ValueError(f"n={n}, block_size={block_size}, window={window}, "
                         f"align={align}: n must divide into blocks and the "
                         "window into slices")
    nb = n // block_size
    S = window // align
    starts, coverage = block_window(
        torch.div(cols, align, rounding_mode="floor"), block_size, S,
        sentinel=n // align)
    cand = (starts[:, :, None] * align
            + torch.arange(align, dtype=cols.dtype, device=cols.device)
            ).reshape(nb, S * align)
    return starts, cand, coverage


def gather_aligned(x: Tensor, starts: Tensor, align: int) -> Tensor:
    """Fetch the aligned slices: x [n, d], starts [nb, S] (units of ``align``
    rows) → [nb, S·align, d]."""
    n, d = x.shape
    nb, S = starts.shape
    xa = x.reshape(n // align, align * d)
    return xa[starts.clamp(0, n // align - 1)].reshape(nb, S * align, d)


def block_masks(cols: Tensor, cand: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
    """emask [nb, B, C] bool: True exactly at each block's (row, neighbour)
    edges. Graph-static: build once per graph, reuse across layers/steps.

    ``cand`` rows are sorted, so each col id locates its slot by
    searchsorted; ids that overflowed the window land on a slot whose
    candidate differs and are dropped by the equality check.
    """
    n, K = cols.shape
    nb, C = cand.shape
    B = n // nb
    flat = cols.reshape(nb, B * K).to(cand.dtype)
    slots = torch.searchsorted(cand.contiguous(), flat).clamp(0, C - 1)
    hit = torch.gather(cand, 1, slots) == flat
    if mask is not None:
        hit = hit & mask.reshape(nb, B * K)
    rows = torch.arange(B, device=cols.device).repeat_interleave(K)
    idx = rows[None, :] * C + slots  # [nb, B·K] into the flattened [B, C]
    counts = torch.zeros((nb, B * C), dtype=torch.int32, device=cols.device)
    counts.scatter_add_(1, idx, hit.to(torch.int32))
    return (counts > 0).reshape(nb, B, C)


def build_block_graph(positions: Tensor, k: int, block_size: int,
                      window: int, pack: bool = False):
    """Spatial sort → kNN → candidate windows → edge masks, in one call.

    Returns ``(perm, cols, cand, emask, coverage)``: apply ``perm`` to every
    per-node array, feed ``cols``/``cand``/``emask`` to the block backend.
    ``pack=True`` bitpacks the mask (``fused_block.pack_emask``), which
    selects the fused CUDA kernel downstream. Callers must surface
    ``coverage``: below 1 the block aggregation drops edges.
    """
    perm = spatial_sort(positions)
    pos = positions[perm]
    cols = knn_graph_auto(pos, k)
    cand, coverage = block_window(cols, block_size, window)
    emask = block_masks(cols, cand)
    if pack:
        emask = pack_emask(emask)
    return perm, cols, cand, emask, coverage


def block_attention(q: Tensor, x: Tensor, v: Tensor, cols: Tensor,
                    cand: Tensor, mask: Optional[Tensor] = None,
                    emask: Optional[Tensor] = None) -> Tensor:
    """Exact k-NN neighbour attention via masked dense per-block products.

    q [n, dq], x [n, dq], v [n, dv], cols [n, K], cand [nb, C] from
    ``block_window``; ``emask`` [nb, B, C] bool from ``block_masks``.
    Returns out [n, dv]; rows with no valid edge give zero. As the
    reference casts: the scores and the softmax in float32 from bfloat16
    inputs, the weights cast to v's type, the value product accumulated in
    float32 (so bfloat16 features give a float32 out); in float32 every
    cast is the identity.
    """
    n, dq = q.shape
    nb, C = cand.shape
    if emask is None:
        emask = block_masks(cols, cand, mask)
    acc = torch.promote_types(q.dtype, torch.float32)
    qb = q.reshape(nb, n // nb, dq)
    candc = cand.clamp(0, n - 1)
    xg = x[candc]  # [nb, C, dq]
    vg = v[candc]  # [nb, C, dv]
    scores = torch.einsum("nbd,ncd->nbc", qb.to(acc),
                          xg.to(acc)).masked_fill(~emask, _NEG)
    attn = torch.softmax(scores, dim=-1).masked_fill(~emask, 0.0)
    out = torch.einsum("nbc,ncd->nbd", attn.to(vg.dtype).to(acc), vg.to(acc))
    return out.reshape(n, -1)
