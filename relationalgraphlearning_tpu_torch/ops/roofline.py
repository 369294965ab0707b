"""The float32 FMA ceiling's kernel: the CUDA wrapper and its plain twin.

Counterpart of ``bench_roofline.py::vpu_peak`` (``:65-81``), whose chain of
``fmas`` FMAs an element a pass XLA fuses into one loop. Eager PyTorch
would launch one kernel an operation and measure the memory, so the chain
is one kernel (``csrc/roofline.cu``) that keeps each element in a register
for every pass. It is a measurement of the card, not a kernel of the
system's path: no TPU kernel stands behind it.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors, or raises; its launches count as ``fma_chain``
(``_build.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build

# x = x * MUL + ADD, the reference's constants (as float32 on both sides)
MUL, ADD = 1.0000001, 1e-9

_lib = _build.Library(
    "roofline.cu", kernels=("fma_chain",),
    fma_chain_launch=[ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p])


def fma_chain_plain(x: Tensor, fmas: int = 128, passes: int = 64) -> Tensor:
    """``passes`` times ``fmas`` of x = x * 1.0000001 + 1e-9, a product
    and a sum rounded apart. From x = 1 every step adds one float32 ulp of
    1 and the sum of 1e-9 rounds away, with or without the fused rounding,
    so the kernel's FMAs give the same bits."""
    for _ in range(passes * fmas):
        x = x * MUL + ADD
    return x


def fma_chain(x: Tensor, fmas: int = 128, passes: int = 64) -> Tensor:
    """x [n] float32 → x after ``passes`` × ``fmas`` chained FMAs."""
    if not x.is_cuda:
        return fma_chain_plain(x, fmas, passes)
    _build.check_tensors(x.device, x=(x, torch.float32))
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.fma_chain_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                   fmas, passes,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"fma_chain (n={x.numel()})")
    _build.count_launch("fma_chain")
    return out
