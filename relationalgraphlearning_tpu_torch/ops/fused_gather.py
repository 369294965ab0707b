"""Fused per-edge gather attention: the CUDA kernel's wrapper and plain twin.

Counterpart of ``relationalgraphlearning_tpu/ops/pallas_graph.py`` and of the
kernel in ``tools/probe_mosaic_gather.py``, which the TPU cannot compile and
keeps gated off. On Hopper it is a real kernel
(``csrc/fused_gather_attention.cu``): per row, scores against the K
neighbours' keys, the masked neighbour softmax and the value aggregation, in
one launch — the math of the fixed-K chain ``sddmm_fixed_k`` →
``neighbor_softmax`` → ``spmm_fixed_k``, with the chain's semantics: a fully
masked row averages its neighbours uniformly, and a duplicate neighbour
counts once per occurrence.

The wrapper runs the plain chain for CPU tensors and launches the kernel for
CUDA tensors, or raises. Its launches count as ``fused_gather_attention``
(``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build, sparse

_MAX_FEATURES = 128         # kMaxF * 32 in the CUDA source

_lib = _build.Library(
    "fused_gather_attention.cu", kernels=("fused_gather_attention",),
    fga_launch=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])
# The last ``cols`` proven in range, with its version: a graph is reused
# for many layers and steps, and its check costs a host synchronisation.
_checked = (None, -1, -1)


def check_ids(cols: Tensor, n: int) -> None:
    """Raise unless every neighbour id lies in [0, n). The kernel reads the
    ids as given; it does not clip."""
    global _checked
    ref, version, n_ok = _checked
    if ref is not None and ref() is cols and version == cols._version \
            and n_ok == n:
        return
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= n):
        raise ValueError(f"cols holds ids outside [0, {n}): "
                         f"[{int(cols.min())}, {int(cols.max())}]")
    _checked = (weakref.ref(cols), cols._version, n)


def fused_gather_attention_plain(q: Tensor, x: Tensor, v: Tensor,
                                 cols: Tensor,
                                 mask: Optional[Tensor] = None) -> Tensor:
    """The port's fixed-K chain: sddmm → neighbour softmax → spmm."""
    scores = sparse.sddmm_fixed_k(q, x, cols, mask)
    return sparse.spmm_fixed_k(sparse.neighbor_softmax(scores, mask), v, cols)


def fused_gather_attention(q: Tensor, x: Tensor, v: Tensor, cols: Tensor,
                           mask: Optional[Tensor] = None) -> Tensor:
    """Kernel #3: q [n, d], x [n, d] f32 keys, v [n, dv] f32 values, cols
    [n, K] int64 neighbour ids in [0, n), mask [n, K] bool or None (every
    edge valid) → [n, dv]."""
    n = x.shape[0]
    check_ids(cols, n)
    if not q.is_cuda:
        return fused_gather_attention_plain(q, x, v, cols, mask)
    nq, d = q.shape
    K = cols.shape[1]
    dv = v.shape[1]
    tensors = dict(q=(q, torch.float32), x=(x, torch.float32),
                   v=(v, torch.float32), cols=(cols, torch.int64))
    if mask is not None:
        tensors["mask"] = (mask, torch.bool)
    _build.check_tensors(q.device, **tensors)
    if x.shape[1] != d or v.shape[0] != n or cols.shape[0] != nq:
        raise ValueError(f"q {tuple(q.shape)}, x {tuple(x.shape)}, v "
                         f"{tuple(v.shape)}, cols {tuple(cols.shape)} do not "
                         "fit together")
    if mask is not None and mask.shape != cols.shape:
        raise ValueError(f"mask {tuple(mask.shape)} is not cols' shape "
                         f"{tuple(cols.shape)}")
    if not (1 <= d <= _MAX_FEATURES and 1 <= dv <= _MAX_FEATURES):
        raise ValueError(f"d={d}, dv={dv}: the kernel takes 1..128")
    if K < 1:
        raise ValueError(f"K={K}: the kernel takes at least one neighbour")
    # keys are values (both main paths pass one table): each neighbour row
    # is then read once, for its score and for its share of the output
    shared = x.data_ptr() == v.data_ptr() and x.shape == v.shape
    out = torch.empty((nq, dv), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fga_launch(
            q.data_ptr(), x.data_ptr(), v.data_ptr(), cols.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), nq, K,
            d, dv, int(shared), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"fused_gather_attention (K={K}, d={d})")
    _build.count_launch("fused_gather_attention")
    return out


def fused_neighbor_attention(q: Tensor, x: Tensor, v: Tensor, cols: Tensor,
                             mask: Optional[Tensor] = None) -> Tensor:
    """The entry point of ``pallas_graph.fused_neighbor_attention``: q [n, d]
    relation queries, x [n, d] keys, v [n, dv] messages, cols [n, K],
    mask [n, K] → [n, dv], through kernel #3 on the card."""
    return fused_gather_attention(q, x, v, cols, mask)
