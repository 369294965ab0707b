"""Fused windowed block attention: the CUDA kernels' wrappers and plain twins.

Counterpart of ``relationalgraphlearning_tpu/ops/pallas_block.py``. The
packed kernels (``csrc/fused_block_attention.cu``, #1 and #2) compute, per
block of B query rows, scores against the block's C candidate rows, a masked
row softmax with the bitpacked edge mask, and the value aggregation with the
divide after the value product, then an optional ``l2norm``/``relu``
epilogue — the math of ``pallas_block._masked_softmax_agg``. Unlike the
Pallas kernels they take the node table and ``cand`` and gather the
candidate rows themselves. The r3 kernel (#5, ``fused_block_attention``)
takes pre-gathered tables and a dense float mask (slots with a value > 0 are
edges), and divides before the value product, as ``pallas_block._kernel``
does; it reads each mask row once into bit words and follows the edges.

Packed masks are ``int32`` with the reference's bits: torch on the CPU
cannot shift ``uint32``, so the port keeps the same 32 bits as a signed word.

#1 and #2 take float32 or bfloat16 features (``qb``, ``x`` and ``v`` all of
one type) and return ``qb``'s type. In bfloat16 they cast where the Pallas
kernel casts (``pallas_block.py:133-154``): the scores and ``e`` in float32,
the denominator the sum of the float32 ``e``, the value product over
``e`` rounded to bfloat16 and accumulated in float32, the divide and the
epilogue in float32, the output rounded to bfloat16.

Every wrapper runs the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors, or raises. Each kernel wrapper's launches count
under its name (``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build

_NEG = -1e30
_EPILOGUES = {"none": 0, "l2norm": 1, "relu": 2}
# #1/#2's entry point by feature type
_LAUNCH = {torch.float32: "fba_launch", torch.bfloat16: "fba_launch_bf16"}
_MAX_FEATURES = 128         # kMaxF * 32 in the CUDA source
ROWS_PER_CTA = 16           # kRowsPerCta in csrc/block_attention.cuh

_FBA_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_lib = _build.Library(
    "fused_block_attention.cu",
    kernels=("fused_block_attention_packed_shared",
             "fused_block_attention_packed", "fused_block_attention"),
    fba_launch=_FBA_ARGS, fba_launch_bf16=_FBA_ARGS,
    fba_dense_launch=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])


# ------------------------------------------------------------ mask packing
def pack_emask(emask: Tensor) -> Tensor:
    """Bitpack a [nb, B, C] bool edge mask along rows → [nb, B//32, C] int32.

    Row ``w*32 + b`` of block n lands in bit ``b`` of word ``[n, w, :]``: the
    bits of ``pallas_block.pack_emask``'s uint32, held as int32.
    """
    nb, B, C = emask.shape
    if B % 32:
        raise ValueError(f"B={B} is not a multiple of 32")
    m = emask.reshape(nb, B // 32, 32, C).to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=emask.device)
    words = (m << shift[None, None, :, None]).sum(dim=2)  # disjoint bits
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_emask(mbits: Tensor, B: int) -> Tensor:
    """[nb, B//32, C] int32 → [nb, B, C] bool: row w*32+b is bit b of word
    w."""
    nb, W, C = mbits.shape
    shift = torch.arange(32, dtype=torch.int32, device=mbits.device)
    bits = (mbits[:, :, None, :] >> shift[None, None, :, None]) & 1
    return (bits != 0).reshape(nb, B, C)


# ------------------------------------------------------------ plain versions
def masked_softmax_agg_plain(qb: Tensor, xg: Tensor, vg: Tensor,
                             mbits: Tensor, epilogue: str = "none",
                             stable: bool = True) -> Tensor:
    """Plain transcription of ``pallas_block._masked_softmax_agg`` over
    pre-gathered tables: qb [nb, B, d], xg [nb, C, d], vg [nb, C, dv] →
    [nb, B, dv] in qb's type. bfloat16 features are widened to float32 for
    the scores, ``e`` is rounded to vg's type before the value product, and
    the output to qb's type after the epilogue, as the kernel casts; in
    float32 (or float64) every cast is the identity."""
    acc = torch.promote_types(qb.dtype, torch.float32)
    mask = unpack_emask(mbits, qb.shape[1])
    scores = torch.einsum("nbd,ncd->nbc", qb.to(acc), xg.to(acc))
    if stable:
        scores = scores.masked_fill(~mask, _NEG)
        smax = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - smax).masked_fill(~mask, 0.0)
    else:
        # unshifted: masked slots may overflow to inf; they are zeroed
        # exactly, as the reference's bitwise AND zeroes them
        e = torch.exp(scores).masked_fill(~mask, 0.0)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-20)
    out = torch.einsum("nbc,ncd->nbd", e.to(vg.dtype).to(acc),
                       vg.to(acc)) / denom
    if epilogue == "l2norm":
        out = out / torch.clamp(
            torch.sqrt((out * out).sum(dim=-1, keepdim=True)), min=1e-6)
    elif epilogue == "relu":
        out = torch.clamp(out, min=0.0)
    return out.to(qb.dtype)


def fused_block_attention_packed_shared_plain(
        qb: Tensor, x: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    xg = x[cand.clamp(0, x.shape[0] - 1)]
    return masked_softmax_agg_plain(qb, xg, xg, mbits, epilogue, stable)


def fused_block_attention_packed_plain(
        qb: Tensor, x: Tensor, v: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    candc = cand.clamp(0, x.shape[0] - 1)
    return masked_softmax_agg_plain(qb, x[candc], v[candc], mbits, epilogue,
                                    stable)


# ------------------------------------------------------------ kernel launch
def _check(qb: Tensor, x: Tensor, v: Tensor, cand: Tensor, mbits: Tensor,
           epilogue: str) -> None:
    nb, B, d = qb.shape
    n, dx = x.shape
    C = cand.shape[-1]
    dt = qb.dtype
    if dt not in _LAUNCH:
        raise TypeError(f"qb is {dt}, the kernel takes {list(_LAUNCH)}")
    for name, t in (("x", x), ("v", v)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype} and qb {dt}: the kernel "
                            "takes one feature type")
    _build.check_tensors(qb.device, qb=(qb, dt), x=(x, dt), v=(v, dt),
                         cand=(cand, torch.int64), mbits=(mbits, torch.int32))
    if B % 32:
        raise ValueError(f"B={B} is not a multiple of 32")
    if dx != d or v.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)} / v {tuple(v.shape)} do not "
                         f"match qb {tuple(qb.shape)}")
    if cand.shape != (nb, C) or mbits.shape != (nb, B // 32, C):
        raise ValueError(f"cand {tuple(cand.shape)} / mbits "
                         f"{tuple(mbits.shape)} do not fit nb={nb}, B={B}")
    if not (1 <= d <= _MAX_FEATURES and 1 <= v.shape[1] <= _MAX_FEATURES):
        raise ValueError(f"d={d}, dv={v.shape[1]}: the kernel takes 1..128")
    if epilogue not in _EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {list(_EPILOGUES)}")
    _build.check_smem(cta_smem_bytes(C), f"a window of C={C}")


def cta_smem_bytes(C: int) -> int:
    """Shared memory a CTA of the windowed kernels #1/#2/#4/#7 takes
    (block_attention.cuh ``cta_smem_bytes``): the C slots' table rows
    (int32), the mask words of its 16 rows (ceil(C/32) each) and each row's
    edge list (a uint16 a slot, padded to an odd number of 4-byte words).
    The rows' features are read from the table, not staged, so d does not
    count."""
    nw = -(-C // 32)
    list_stride = (C + 3) // 4 * 4 + 2
    return 4 * C + 4 * ROWS_PER_CTA * nw + 2 * ROWS_PER_CTA * list_stride


def _launch(qb, x, v, cand, mbits, shared, epilogue, stable) -> Tensor:
    _check(qb, x, v, cand, mbits, epilogue)
    nb, B, d = qb.shape
    dv = v.shape[1]
    out = torch.empty((nb, B, dv), dtype=qb.dtype, device=qb.device)
    lib = _lib()
    with torch.cuda.device(qb.device):
        err = getattr(lib, _LAUNCH[qb.dtype])(
            qb.data_ptr(), x.data_ptr(), v.data_ptr(), cand.data_ptr(),
            mbits.data_ptr(), out.data_ptr(), nb, B, cand.shape[1], d, dv,
            x.shape[0], int(shared), int(stable), _EPILOGUES[epilogue],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"fused_block_attention (C={cand.shape[1]}"
                        f", d={d})")
    return out


def fused_block_attention_packed_shared(
        qb: Tensor, x: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    """Kernel #1, values ≡ keys: qb [nb, B, d], node table x [n, d] (both
    float32 or both bfloat16), cand [nb, C] int64 (sentinel n), mbits
    [nb, B//32, C] int32 → [nb, B, d] in qb's type."""
    if not qb.is_cuda:
        return fused_block_attention_packed_shared_plain(
            qb, x, cand, mbits, epilogue, stable)
    out = _launch(qb, x, x, cand, mbits, True, epilogue, stable)
    _build.count_launch("fused_block_attention_packed_shared")
    return out


def fused_block_attention_packed(
        qb: Tensor, x: Tensor, v: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    """Kernel #2, a separate value table v [n, dv] → [nb, B, dv]."""
    if not qb.is_cuda:
        return fused_block_attention_packed_plain(
            qb, x, v, cand, mbits, epilogue, stable)
    out = _launch(qb, x, v, cand, mbits, False, epilogue, stable)
    _build.count_launch("fused_block_attention_packed")
    return out


# ------------------------------------------------- the r3 kernel (kernel #5)
def fused_block_attention_plain(qb: Tensor, xg: Tensor, vg: Tensor,
                                emask: Tensor) -> Tensor:
    """Plain transcription of ``pallas_block._kernel`` (the r3 kernel):
    stable masked softmax with the divide BEFORE the value product."""
    m = emask > 0
    scores = torch.einsum("nbd,ncd->nbc", qb, xg).masked_fill(~m, _NEG)
    smax = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - smax) * m
    attn = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-20)
    return torch.einsum("nbc,ncd->nbd", attn, vg)


def fused_block_attention(qb: Tensor, xg: Tensor, vg: Tensor,
                          emask: Tensor) -> Tensor:
    """Kernel #5, the r3 form: qb [nb, B, d], pre-gathered xg [nb, C, d] and
    vg [nb, C, dv], emask [nb, B, C] (bool or float; slots with emask > 0
    are edges; the kernel reads f32) → [nb, B, dv]. The launch itself
    refuses a window too wide for the card's shared memory (C above about
    28,000 on an H100), and this raises."""
    if not qb.is_cuda:
        return fused_block_attention_plain(qb, xg, vg, emask)
    if emask.dtype != torch.float32:
        emask = emask.to(torch.float32)
    nb, B, d = qb.shape
    C, dv = xg.shape[1], vg.shape[2]
    _build.check_tensors(qb.device, qb=(qb, torch.float32),
                         xg=(xg, torch.float32), vg=(vg, torch.float32),
                         emask=(emask, torch.float32))
    if B % 32:
        raise ValueError(f"B={B} is not a multiple of 32")
    if (xg.shape != (nb, C, d) or vg.shape[:2] != (nb, C)
            or emask.shape != (nb, B, C)):
        raise ValueError(f"xg {tuple(xg.shape)} / vg {tuple(vg.shape)} / "
                         f"emask {tuple(emask.shape)} do not fit qb "
                         f"{tuple(qb.shape)}")
    if not (1 <= d <= _MAX_FEATURES and 1 <= dv <= _MAX_FEATURES):
        raise ValueError(f"d={d}, dv={dv}: the kernel takes 1..128")
    out = torch.empty((nb, B, dv), dtype=torch.float32, device=qb.device)
    lib = _lib()
    with torch.cuda.device(qb.device):
        err = lib.fba_dense_launch(
            qb.data_ptr(), xg.data_ptr(), vg.data_ptr(), emask.data_ptr(),
            out.data_ptr(), nb, B, C, d, dv,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"fused_block_attention r3 (C={C}, d={d})")
    _build.count_launch("fused_block_attention")
    return out


# ------------------------------------------------------------- entry points
def block_attention_fused(q: Tensor, x: Tensor, v: Tensor, cand: Tensor,
                          emask: Tensor, epilogue: str = "none",
                          stable: bool = True) -> Tensor:
    """Drop-in for ``block_graph.block_attention`` with a precomputed mask
    (counterpart of ``pallas_block.block_attention_pallas``).

    ``emask`` is the [nb, B, C] bool mask (packed here per call) or the
    [nb, B//32, C] int32 from ``pack_emask`` (pack once per graph). When x
    and v are the same tensor the single-table kernel runs.
    """
    n, dq = q.shape
    nb = cand.shape[0]
    B = n // nb
    mbits = emask if emask.dtype == torch.int32 else pack_emask(emask)
    qb = q.reshape(nb, B, dq).contiguous()
    if v is x:
        out = fused_block_attention_packed_shared(qb, x, cand, mbits,
                                                  epilogue, stable)
    else:
        out = fused_block_attention_packed(qb, x, v, cand, mbits, epilogue,
                                           stable)
    return out.reshape(n, -1)


def aligned_cand(starts: Tensor, align: int) -> Tensor:
    """The expanded row ids of ``block_window_aligned``'s slice starts:
    [nb, S] → [nb, S·align] (sentinel starts give ids ≥ n, clipped by the
    kernel; their mask bits are never set)."""
    nb, S = starts.shape
    offs = torch.arange(align, dtype=starts.dtype, device=starts.device)
    return (starts[:, :, None] * align + offs).reshape(nb, S * align)


def block_attention_fused_aligned_plain(
        q: Tensor, x: Tensor, v: Tensor, starts: Tensor, align: int,
        mbits: Tensor, epilogue: str = "none", stable: bool = True) -> Tensor:
    """The reference's composition: ``gather_aligned`` tables, then the
    packed kernel's math."""
    # imported here: block_graph imports this module for pack_emask
    from relationalgraphlearning_tpu_torch.ops.block_graph import (
        gather_aligned)

    n, dq = q.shape
    nb = starts.shape[0]
    xg = gather_aligned(x, starts, align)
    vg = xg if v is x else gather_aligned(v, starts, align)
    out = masked_softmax_agg_plain(q.reshape(nb, n // nb, dq), xg, vg, mbits,
                                   epilogue, stable)
    return out.reshape(n, -1)


def block_attention_fused_aligned(
        q: Tensor, x: Tensor, v: Tensor, starts: Tensor, align: int,
        mbits: Tensor, epilogue: str = "none", stable: bool = True) -> Tensor:
    """Counterpart of ``pallas_block.block_attention_pallas_aligned``:
    candidates arrive as ``align``-row slice starts [nb, S]
    (``block_graph.block_window_aligned``) with the packed mask over their
    S·align expanded slots. The kernels gather through ``cand`` themselves,
    so the expanded ids go straight to kernel #1 (x is v) or #2, with no
    ``gather_aligned`` table in between."""
    if not q.is_cuda:
        return block_attention_fused_aligned_plain(q, x, v, starts, align,
                                                   mbits, epilogue, stable)
    return block_attention_fused(q, x, v, aligned_cand(starts, align), mbits,
                                 epilogue, stable)
