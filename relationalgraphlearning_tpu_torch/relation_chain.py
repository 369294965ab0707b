"""The relational op at crowd scale: a loop-carried relation-edge chain.

Counterpart of ``bench_extra.py::edges_throughput``/``edges_throughput_block``
(``:76-190``), ``bench_roofline.py::graph_chain`` (``:99-130``) and the
chain of ``tools/probe_chunk_d32.py`` (``:166-184``). Over a seeded,
spatially sorted kNN crowd, h ← route(h) runs ``inner`` times with
q = x = v = the previous output, as stacked SparseRGL layers see it, so no
iteration can be hoisted out of the loop. Every route computes the same
function, the neighbour softmax aggregation followed by a row
l2-normalisation (h / max(‖h‖, 1e-6)):

- ``"gather"``: the fixed-K chain sddmm → neighbour softmax → spmm, then the
  normalisation (``bench_extra.py:92-101``);
- ``"gather_kernel"``: kernel #3 (``ops/fused_gather.py``), then the same
  normalisation (``bench_roofline.py:115-122``);
- ``"block"``: kernel #1 over ``block_window`` candidates with the fused
  ``l2norm`` epilogue and the unshifted softmax (``bench_extra.py:162-176``;
  ``prepare(..., stable=True)`` for the stable one of
  ``bench_roofline.py:218-255``);
- ``"block_dense"``: the windowed dense block path in plain PyTorch
  (``block_graph.block_attention`` with the stable softmax), then the
  normalisation (``bench_extra.py:178-190``, the reference's XLA path);
- ``"chunk"``: kernel #4 over ``chunk_window(cols, B)`` with the same
  epilogue and softmax (``bench_extra.py:141-160``);
- ``"chunk_d32"``: kernel #7, the same with ``groups=4``, the d=32 form.

The unshifted softmax needs |q·x| ≤ 1, which unit rows give: the seed
features are row-normalised, and every route's output is. The block and
chunk routes equal the gather chain when their coverage is 1.

Features may be float32 or, on the gather, block and block_dense routes,
bfloat16 (``bench_roofline.py:99-130``, ``:177-255``): h is read in its
type, the route computes as the reference does on such inputs (the gather
chain and the dense block scores in float32; kernel #1 as
``ops/fused_block.py`` says), and the output is cast back to h's type after
the normalisation, where the reference places ``out.astype(dtype)``.

Timing is the caller's: ``run`` is the eager loop, what a Python caller
pays a launch at a time; ``runner`` captures the ``inner`` applications as
one CUDA graph on the card, the counterpart of the reference's jitted scan.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.ops import block_graph, sparse
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    fused_block_attention_packed_shared, pack_emask)
from relationalgraphlearning_tpu_torch.ops.fused_chunk import (
    chunk_block_attention, chunk_window)
from relationalgraphlearning_tpu_torch.ops.fused_gather import (
    fused_gather_attention, fused_gather_attention_plain)

ROUTES = ("gather", "gather_kernel", "block", "block_dense", "chunk",
          "chunk_d32")


def crowd_graph(n: int = 8192, K: int = 16, side: float = 100.0,
                seed: int = 0, device="cuda", sort: bool = True) -> Tensor:
    """cols [n, K] of the exact kNN graph over n uniform positions in
    [0, side]², spatially sorted so blocks of rows are local (``sort=False``:
    in the order drawn, as ``bench_roofline.py::graph_chain`` builds it)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pos = (torch.rand((n, 2), generator=g) * side).to(device)
    if sort:
        pos = pos[block_graph.spatial_sort(pos)]
    return sparse.knn_graph(pos, K)


def seed_features(n: int, d: int, seed: int = 1, device="cuda",
                  dtype=torch.float32) -> Tensor:
    """Unit-norm rows [n, d] (normalised in float32, then cast to
    ``dtype``): the unshifted softmax's |q·x| ≤ 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return normalize(torch.randn((n, d), generator=g)).to(device, dtype)


def normalize(h: Tensor) -> Tensor:
    return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                           min=1e-6)


def prepare(route: str, cols: Tensor, B: int = 256, C: int = 544,
            stable: bool = False) -> dict:
    """The graph-static artifacts of ``route``, built once per graph, and
    its ``coverage`` (1.0 for the gather routes). ``stable`` selects kernel
    #1's max-shifted softmax on the block route (the others always shift or
    never need to)."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    prep = dict(route=route, cols=cols, stable=stable,
                coverage=torch.ones((), device=cols.device))
    if route in ("block", "block_dense"):
        cand, cov = block_graph.block_window(cols, B, C)
        emask = block_graph.block_masks(cols, cand)
        prep.update(cand=cand, coverage=cov)
        if route == "block":
            prep.update(mbits=pack_emask(emask))
        else:
            prep.update(emask=emask)
    elif route in ("chunk", "chunk_d32"):
        groups = 4 if route == "chunk_d32" else 2
        starts, tail, mbits, cov = chunk_window(cols, B, groups=groups)
        prep.update(starts=starts, tail=tail, mbits=mbits, coverage=cov,
                    groups=groups)
    return prep


def apply(prep: dict, h: Tensor) -> Tensor:
    """One application of the route: h [n, d] → [n, d], unit rows."""
    route, cols = prep["route"], prep["cols"]
    if route == "gather":
        # the reference's sddmm/spmm accumulate in float32 from bfloat16
        hf = h.to(torch.promote_types(h.dtype, torch.float32))
        return normalize(fused_gather_attention_plain(hf, hf, hf,
                                                      cols)).to(h.dtype)
    if route == "gather_kernel":
        return normalize(fused_gather_attention(h, h, h, cols))
    n, d = h.shape
    if route == "block":
        nb = prep["cand"].shape[0]
        return fused_block_attention_packed_shared(
            h.reshape(nb, n // nb, d), h, prep["cand"], prep["mbits"],
            epilogue="l2norm", stable=prep["stable"]).reshape(n, d)
    if route == "block_dense":
        return normalize(block_graph.block_attention(
            h, h, h, cols, prep["cand"], emask=prep["emask"])).to(h.dtype)
    return chunk_block_attention(h, h, prep["starts"], prep["tail"],
                                 prep["mbits"], epilogue="l2norm",
                                 stable=False, groups=prep["groups"])


def run(prep: dict, h: Tensor, inner: int) -> Tensor:
    for _ in range(inner):
        h = apply(prep, h)
    return h


def runner(prep: dict, h0: Tensor, inner: int,
           graphed: Optional[bool] = None) -> Callable[[Tensor], Tensor]:
    """f(h) → h after ``inner`` applications of the route, for features of
    h0's shape. ``graphed`` (default: whether h0 is on the card) captures
    the ``inner`` applications once as one CUDA graph (``captured.Graphed``,
    whose ``launches`` gives the kernel launches one call holds; CPU
    tensors raise); ``graphed=False`` is the eager loop ``run``."""
    if graphed is None:
        graphed = h0.is_cuda
    if graphed:
        return Graphed(lambda h: run(prep, h, inner), h0)
    return lambda h: run(prep, h, inner)


def relation_chain(h0: Tensor, cols: Tensor, route: str, inner: int = 100,
                   B: int = 256, C: int = 544):
    """h0 [n, d] unit rows, cols [n, K] → (h after ``inner`` applications of
    ``route``, the route's window coverage)."""
    prep = prepare(route, cols, B, C)
    return run(prep, h0, inner), prep["coverage"]
