"""Chunked-fetch block attention: the window construction, the CUDA
kernel's wrapper and its plain twin.

Counterpart of ``relationalgraphlearning_tpu/ops/pallas_chunk.py`` and of
``tools/probe_chunk_d32.py``. ``chunk_window`` splits each block's candidate
set into up to ``nch`` mostly dense aligned chunks of ``chunk`` table rows
and a ``ct``-slot tail of single rows, with the edge mask bitpacked in the
reference's slot order; its outputs are bit-equal to the reference's
(``starts`` and ``tail`` as integers, ``mbits`` as int32 with the uint32's
bits). ``chunk_block_attention`` runs the masked softmax of the block kernels
over [chunks; tail]; the CUDA kernel (``csrc/chunk_block_attention.cu``)
fetches the chunk rows and the tail rows itself.

The slot order inside the chunk part depends on ``groups`` (g): the
reference lays the chunk rows out residue by residue mod g (g = 2 for
d = 64, g = 4 for d = 32). The reference kernel assumes g = 2 and misreads a
g = 4 mask; here ``groups`` is an argument of the attention as well as of
``chunk_window``, and the two must agree.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.ops.block_graph import block_window
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    _EPILOGUES, _MAX_FEATURES, cta_smem_bytes, masked_softmax_agg_plain,
    pack_emask)

_lib = _build.Library(
    "chunk_block_attention.cu", kernels=("chunk_block_attention",),
    cba_launch=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
    + [ctypes.c_void_p])


# --------------------------------------------------------------- the window
def chunk_window(cols: Tensor, block_size: int, nch: int = 2, ct: int = 288,
                 thresh: int = 80, chunk: int = 128, groups: int = 2
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Split each block's candidate set into dense aligned chunks + tail.

    cols [n, K] → ``(chunk_starts [nb, nch] int32`` table-row starts,
    multiples of ``chunk`` (0 for empty slots, whose mask bits are 0),
    ``tail [nb, ct]`` candidate ids (sentinel n), ``mbits [nb, B//32,
    nch·chunk + ct] int32`` packed edge mask over the [chunk rows ≡ 0 mod g;
    ≡ 1; …; tail] slot layout, ``coverage``).

    A chunk is selected iff ≥ ``thresh`` of its rows are candidates of the
    block and a chunk slot is free; every other candidate goes to the tail.
    Edges beyond ``ct`` tail slots drop; ``coverage`` is the kept fraction.
    """
    n, K = cols.shape
    if n % block_size or n % chunk or chunk % groups:
        raise ValueError(f"n={n}, block_size={block_size}, chunk={chunk}, "
                         f"groups={groups}: n must divide into blocks and "
                         "chunks, and a chunk into groups")
    dev = cols.device
    nb = n // block_size
    ncell = n // chunk

    # presence bitmap per block [nb, n]
    rows = torch.arange(nb, device=dev).repeat_interleave(block_size * K)
    bitmap = torch.zeros((nb, n), dtype=torch.bool, device=dev)
    bitmap[rows, cols.reshape(-1)] = True
    full = bitmap.reshape(nb, ncell, chunk).sum(-1) >= thresh  # [nb, ncell]

    # the first nch dense chunks, ascending
    slot = torch.cumsum(full, dim=-1) - 1
    ok = full & (slot < nch)
    dump = torch.where(ok, slot, nch)
    cidx = torch.arange(ncell, dtype=torch.int32, device=dev).expand(nb, -1)
    buf = torch.zeros((nb, nch + 1), dtype=torch.int32, device=dev)
    chunk_starts = buf.scatter(1, dump, cidx)[:, :nch] * chunk

    # tail = candidates outside a selected chunk: chunk-covered ids become
    # the sentinel n, which block_window counts as one more id
    colsb = cols.reshape(nb, block_size, K)
    cell = torch.div(colsb, chunk, rounding_mode="floor")
    in_sel = torch.gather(ok, 1, cell.reshape(nb, -1)).reshape(cell.shape)
    tail_src = torch.where(in_sel, n, colsb).reshape(n, K)
    tail, _ = block_window(tail_src, block_size, ct)

    # slot of every edge in the [residue 0; residue 1; …; tail] layout
    g = groups
    part_w = nch * chunk // g
    sel_pos = torch.cumsum(ok.to(torch.int64), dim=-1) - 1
    edge_sel = torch.gather(sel_pos, 1, cell.reshape(nb, -1)).reshape(
        cell.shape)
    off = colsb % chunk
    chunk_slot = (off % g) * part_w + edge_sel * (chunk // g) + off // g
    flat = colsb.reshape(nb, -1)
    tail_slot = torch.searchsorted(tail.contiguous(), flat).clamp(0, ct - 1)
    tail_hit = (torch.gather(tail, 1, tail_slot) == flat).reshape(cell.shape)
    slot_all = torch.where(in_sel, chunk_slot,
                           nch * chunk + tail_slot.reshape(cell.shape))
    hit = in_sel | tail_hit
    ntot = nch * chunk + ct

    r = torch.arange(block_size, device=dev).repeat_interleave(K)
    idx = r[None, :] * ntot + slot_all.reshape(nb, -1)
    counts = torch.zeros((nb, block_size * ntot), dtype=torch.int32,
                         device=dev)
    counts.scatter_add_(1, idx, hit.reshape(nb, -1).to(torch.int32))
    emask = (counts > 0).reshape(nb, block_size, ntot)
    coverage = hit.float().mean()
    return chunk_starts, tail, pack_emask(emask), coverage


def chunk_slot_ids(chunk_starts: Tensor, tail: Tensor, n: int, chunk: int,
                   groups: int) -> Tensor:
    """The table row of every window slot, [nb, nch·chunk + ct], clipped to
    [0, n): slot r·part_w + c·(chunk/g) + j of the chunk part holds row
    chunk_starts[b, c] + j·g + r; tail slots hold their ids."""
    nb, nch = chunk_starts.shape
    hc = chunk // groups
    r = torch.arange(groups, device=tail.device)[:, None, None]
    j = torch.arange(hc, device=tail.device)[None, None, :]
    rows = (chunk_starts.to(tail.dtype)[:, None, :, None]
            + (j * groups + r)[None])                   # [nb, g, nch, hc]
    ids = torch.cat([rows.reshape(nb, nch * chunk), tail], dim=1)
    return ids.clamp(0, n - 1)


# ---------------------------------------------------------- the attention
def _split(chunk_starts: Tensor, tail: Tensor, mbits: Tensor):
    nch, ct, ntot = chunk_starts.shape[1], tail.shape[1], mbits.shape[-1]
    chunk = (ntot - ct) // nch      # the slots encode the chunk size
    if nch * chunk + ct != ntot:
        raise ValueError(f"mbits has {ntot} slots, not nch·chunk + ct for "
                         f"nch={nch}, ct={ct}")
    return nch, ct, chunk


def chunk_block_attention_plain(q: Tensor, x: Tensor, chunk_starts: Tensor,
                                tail: Tensor, mbits: Tensor,
                                epilogue: str = "none", stable: bool = True,
                                groups: int = 2) -> Tensor:
    """The kernel's math on gathered tables: the window's rows by
    ``chunk_slot_ids``, then the packed kernels' masked softmax."""
    n, d = q.shape
    nb = chunk_starts.shape[0]
    _, _, chunk = _split(chunk_starts, tail, mbits)
    xg = x[chunk_slot_ids(chunk_starts, tail, x.shape[0], chunk, groups)]
    out = masked_softmax_agg_plain(q.reshape(nb, n // nb, d), xg, xg, mbits,
                                   epilogue, stable)
    return out.reshape(n, d)


def chunk_block_attention(q: Tensor, x: Tensor, chunk_starts: Tensor,
                          tail: Tensor, mbits: Tensor, epilogue: str = "none",
                          stable: bool = True, groups: int = 2) -> Tensor:
    """Kernels #4 (groups=2) and #7 (groups=4): q [n, d] (block-reshaped
    inside), x [n, d] the shared key/value table, and ``chunk_window``'s
    chunk_starts [nb, nch] int32, tail [nb, ct] int64, mbits [nb, B//32,
    ntot] int32, built with the same ``groups`` → out [n, d]."""
    if not q.is_cuda:
        return chunk_block_attention_plain(q, x, chunk_starts, tail, mbits,
                                           epilogue, stable, groups)
    n, d = q.shape
    nb = chunk_starts.shape[0]
    nch, ct, chunk = _split(chunk_starts, tail, mbits)
    B = n // nb
    _build.check_tensors(q.device, q=(q, torch.float32), x=(x, torch.float32),
                         chunk_starts=(chunk_starts, torch.int32),
                         tail=(tail, torch.int64), mbits=(mbits, torch.int32))
    if n % nb or B % 32:
        raise ValueError(f"n={n} over nb={nb} blocks: B={n / nb} is not a "
                         "multiple of 32")
    if x.shape[1] != d or tail.shape[0] != nb or \
            mbits.shape != (nb, B // 32, nch * chunk + ct):
        raise ValueError(f"q {tuple(q.shape)}, x {tuple(x.shape)}, tail "
                         f"{tuple(tail.shape)}, mbits {tuple(mbits.shape)} "
                         "do not fit together")
    if chunk % groups:
        raise ValueError(f"chunk={chunk} is not a multiple of "
                         f"groups={groups}")
    if not 1 <= d <= _MAX_FEATURES:
        raise ValueError(f"d={d}: the kernel takes 1..128")
    if epilogue not in _EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {list(_EPILOGUES)}")
    ntot = nch * chunk + ct
    _build.check_smem(cta_smem_bytes(ntot), f"a window of {ntot} slots")
    out = torch.empty((n, d), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.cba_launch(
            q.data_ptr(), x.data_ptr(), chunk_starts.data_ptr(),
            tail.data_ptr(), mbits.data_ptr(), out.data_ptr(), nb, B, nch,
            chunk, ct, groups, d, x.shape[0], int(stable),
            _EPILOGUES[epilogue], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"chunk_block_attention (ntot={ntot}, "
                        f"d={d}, groups={groups})")
    _build.count_launch("chunk_block_attention")
    return out
