"""Fused windowed block attention: the CUDA kernel's wrappers and plain twins.

Counterpart of ``relationalgraphlearning_tpu/ops/pallas_block.py``. The
kernel (``csrc/fused_block_attention.cu``) computes, per block of B query
rows, scores against the block's C candidate rows, a masked row softmax with
the bitpacked edge mask, and the value aggregation with the divide after the
value product, then an optional ``l2norm``/``relu`` epilogue — the math of
``pallas_block._masked_softmax_agg``. Unlike the Pallas kernel it takes the
node table and ``cand`` and gathers the candidate rows itself.

Packed masks are ``int32`` with the reference's bits: torch on the CPU
cannot shift ``uint32``, so the port keeps the same 32 bits as a signed word.

Every wrapper runs the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors, or raises. ``launches`` on each kernel wrapper counts
its kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch import Tensor

_NEG = -1e30
_EPILOGUES = {"none": 0, "l2norm": 1, "relu": 2}
_MAX_FEATURES = 128         # kMaxF * 32 in the CUDA source

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_block_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


# ------------------------------------------------------------------ the build
def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/fused_block_attention.cu")
    return found


def library_path() -> Path:
    """Where the built library lives; the name carries the source's hash,
    so an edited source builds anew."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_block_attention_{tag}.so"


def build_command(out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build() -> str:
    """Compile the kernel for sm_90a unless it is built; return nvcc's
    report (registers, shared memory, spills) or "" when it was built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.fba_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.fba_launch.restype = ctypes.c_int
        lib.fba_error_string.argtypes = [ctypes.c_int]
        lib.fba_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    pre-gathered tables: qb [nb, B, d], xg [nb, C, d], vg [nb, C, dv]."""
    mask = unpack_emask(mbits, qb.shape[1])
    scores = torch.einsum("nbd,ncd->nbc", qb, xg)
    if stable:
        scores = scores.masked_fill(~mask, _NEG)
        smax = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - smax).masked_fill(~mask, 0.0)
    else:
        # unshifted: masked slots may overflow to inf; they are zeroed
        # exactly, as the reference's bitwise AND zeroes them
        e = torch.exp(scores).masked_fill(~mask, 0.0)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-20)
    out = torch.einsum("nbc,ncd->nbd", e, vg) / denom
    if epilogue == "l2norm":
        out = out / torch.clamp(
            torch.sqrt((out * out).sum(dim=-1, keepdim=True)), min=1e-6)
    elif epilogue == "relu":
        out = torch.clamp(out, min=0.0)
    return out


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
    for name, t, dt in (("qb", qb, torch.float32), ("x", x, torch.float32),
                        ("v", v, torch.float32), ("cand", cand, torch.int64),
                        ("mbits", mbits, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not on a CUDA device")
        if t.device != qb.device:
            raise ValueError(f"{name} is on {t.device}, qb on {qb.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
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


def _launch(qb, x, v, cand, mbits, shared, epilogue, stable) -> Tensor:
    _check(qb, x, v, cand, mbits, epilogue)
    nb, B, d = qb.shape
    dv = v.shape[1]
    out = torch.empty((nb, B, dv), dtype=torch.float32, device=qb.device)
    lib = _library()
    with torch.cuda.device(qb.device):
        err = lib.fba_launch(
            qb.data_ptr(), x.data_ptr(), v.data_ptr(), cand.data_ptr(),
            mbits.data_ptr(), out.data_ptr(), nb, B, cand.shape[1], d, dv,
            x.shape[0], int(shared), int(stable), _EPILOGUES[epilogue],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_block_attention launch failed (C={cand.shape[1]}, "
            f"d={d}): CUDA error {err}, {lib.fba_error_string(err).decode()}")
    return out


def fused_block_attention_packed_shared(
        qb: Tensor, x: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    """Kernel #1, values ≡ keys: qb [nb, B, d] f32, node table x [n, d] f32,
    cand [nb, C] int64 (sentinel n), mbits [nb, B//32, C] int32 →
    [nb, B, d]."""
    if not qb.is_cuda:
        return fused_block_attention_packed_shared_plain(
            qb, x, cand, mbits, epilogue, stable)
    out = _launch(qb, x, x, cand, mbits, True, epilogue, stable)
    fused_block_attention_packed_shared.launches += 1
    return out


def fused_block_attention_packed(
        qb: Tensor, x: Tensor, v: Tensor, cand: Tensor, mbits: Tensor,
        epilogue: str = "none", stable: bool = True) -> Tensor:
    """Kernel #2, a separate value table v [n, dv] → [nb, B, dv]."""
    if not qb.is_cuda:
        return fused_block_attention_packed_plain(
            qb, x, v, cand, mbits, epilogue, stable)
    out = _launch(qb, x, v, cand, mbits, False, epilogue, stable)
    fused_block_attention_packed.launches += 1
    return out


fused_block_attention_packed_shared.launches = 0
fused_block_attention_packed.launches = 0


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


def reset_launch_counts() -> None:
    fused_block_attention_packed_shared.launches = 0
    fused_block_attention_packed.launches = 0


def launch_counts() -> dict:
    return {"fused_block_attention_packed_shared":
            fused_block_attention_packed_shared.launches,
            "fused_block_attention_packed":
            fused_block_attention_packed.launches}
