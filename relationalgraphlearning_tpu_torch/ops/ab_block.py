"""The A/B harness's block attention (kernel #6): its CUDA wrapper and plain
twin.

Counterpart of ``tools/ab_kernel.py::make_kernel`` (``pallas_call`` at
``:73``, body ``:36-88``). Per block of B query rows against the block's
pre-gathered window xg [nb, C, d] (keys ≡ values) and the bitpacked edge mask
[nb, B//32, C] (row w·32+b is bit b of word w):

- scores = q·xᵀ over all C slots, accumulated in float32;
- e = exp(scores), unshifted, then masked: a bool select, or with
  ``intmask`` each bit sign-smeared to a 0/−1 int32 word and ANDed into the
  bits of exp;
- denom = max(Σe, 1e-20);
- ``div_after``: (e rounded to x's dtype)·X / denom; else
  ((e / denom) rounded to x's dtype)·X, products in float32;
- a fixed l2norm epilogue (row / max(‖row‖, 1e-6)), stored in qb's dtype.

qb and xg are both float32 or both bfloat16. The unshifted softmax needs
|q·x| ≤ 1, which unit rows give. Rows with no edge give exactly 0.

The wrapper runs the plain version for CPU tensors and launches the kernel
(``csrc/ab_block_attention.cu``: the window streams through shared memory in
tiles, both products on the tensor cores, float32 as 3xTF32) for CUDA
tensors, or raises. Its launches count as ``ab_block_attention``
(``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    _MAX_FEATURES, unpack_emask)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = _build.Library(
    "ab_block_attention.cu", kernels=("ab_block_attention",),
    aba_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p])


# ------------------------------------------------------------ plain version
def ab_block_attention_plain(qb: Tensor, xg: Tensor, mbits: Tensor,
                             div_after: bool = False,
                             intmask: bool = False) -> Tensor:
    """Plain transcription of ``ab_kernel.py:37-69``: qb [nb, B, d], xg
    [nb, C, d] (float32 or bfloat16), mbits [nb, B//32, C] int32 →
    [nb, B, d] in qb's dtype."""
    nb, B, _ = qb.shape
    C = xg.shape[1]
    x = xg.float()
    scores = torch.einsum("nbd,ncd->nbc", qb.float(), x)
    if intmask:
        shift = torch.arange(32, dtype=torch.int32, device=mbits.device)
        m32 = ((mbits[:, :, None, :] << (31 - shift)[None, None, :, None])
               >> 31).reshape(nb, B, C)
        e = (torch.exp(scores).view(torch.int32) & m32).view(torch.float32)
    else:
        e = torch.where(unpack_emask(mbits, B), torch.exp(scores), 0.0)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-20)
    if div_after:
        out = torch.einsum("nbc,ncd->nbd", e.to(xg.dtype).float(), x) / denom
    else:
        attn = (e / denom).to(xg.dtype).float()
        out = torch.einsum("nbc,ncd->nbd", attn, x)
    out = out / torch.clamp(
        torch.sqrt((out * out).sum(dim=-1, keepdim=True)), min=1e-6)
    return out.to(qb.dtype)


# ------------------------------------------------------------ kernel launch
def ab_block_attention(qb: Tensor, xg: Tensor, mbits: Tensor,
                       div_after: bool = False,
                       intmask: bool = False) -> Tensor:
    """Kernel #6: qb [nb, B, d], xg [nb, C, d] of one dtype (float32 or
    bfloat16), mbits [nb, B//32, C] int32 → [nb, B, d] in that dtype."""
    if not qb.is_cuda:
        return ab_block_attention_plain(qb, xg, mbits, div_after, intmask)
    if qb.dtype not in _DTYPES:
        raise TypeError(f"qb is {qb.dtype}, the kernel takes float32 or "
                        "bfloat16")
    nb, B, d = qb.shape
    C = xg.shape[1]
    _build.check_tensors(qb.device, qb=(qb, qb.dtype), xg=(xg, qb.dtype),
                         mbits=(mbits, torch.int32))
    if B % 32:
        raise ValueError(f"B={B} is not a multiple of 32")
    if xg.shape != (nb, C, d) or mbits.shape != (nb, B // 32, C):
        raise ValueError(f"xg {tuple(xg.shape)} / mbits {tuple(mbits.shape)} "
                         f"do not fit qb {tuple(qb.shape)}")
    if not 1 <= d <= _MAX_FEATURES:
        raise ValueError(f"d={d}: the kernel takes 1..128")
    out = torch.empty_like(qb)
    lib = _lib()
    with torch.cuda.device(qb.device):
        err = lib.aba_launch(
            qb.data_ptr(), xg.data_ptr(), mbits.data_ptr(), out.data_ptr(),
            nb, B, C, d, _DTYPES[qb.dtype], int(div_after), int(intmask),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"ab_block_attention (C={C}, d={d}, "
                        f"{qb.dtype})")
    _build.count_launch("ab_block_attention")
    return out
