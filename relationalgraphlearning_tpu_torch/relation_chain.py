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
  ``l2norm`` epilogue and the unshifted softmax (``bench_extra.py:162-176``);
- ``"chunk"``: kernel #4 over ``chunk_window(cols, B)`` with the same
  epilogue and softmax (``bench_extra.py:141-160``);
- ``"chunk_d32"``: kernel #7, the same with ``groups=4``, the d=32 form.

The unshifted softmax needs |q·x| ≤ 1, which unit rows give: the seed
features are row-normalised, and every route's output is. The block and
chunk routes equal the gather chain when their coverage is 1. Timing is the
caller's: ``run`` is the eager loop, what a Python caller pays a launch at a
time; ``runner`` captures the ``inner`` applications as one CUDA graph on the
card, the counterpart of the reference's jitted scan.
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

ROUTES = ("gather", "gather_kernel", "block", "chunk", "chunk_d32")


def crowd_graph(n: int = 8192, K: int = 16, side: float = 100.0,
                seed: int = 0, device="cuda") -> Tensor:
    """cols [n, K] of the exact kNN graph over n uniform positions in
    [0, side]², spatially sorted so blocks of rows are local."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pos = (torch.rand((n, 2), generator=g) * side).to(device)
    pos = pos[block_graph.spatial_sort(pos)]
    return sparse.knn_graph(pos, K)


def seed_features(n: int, d: int, seed: int = 1, device="cuda") -> Tensor:
    """Unit-norm rows [n, d]: the unshifted softmax's |q·x| ≤ 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return normalize(torch.randn((n, d), generator=g)).to(device)


def normalize(h: Tensor) -> Tensor:
    return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                           min=1e-6)


def prepare(route: str, cols: Tensor, B: int = 256, C: int = 544) -> dict:
    """The graph-static artifacts of ``route``, built once per graph, and
    its ``coverage`` (1.0 for the gather routes)."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    prep = dict(route=route, cols=cols,
                coverage=torch.ones((), device=cols.device))
    if route == "block":
        cand, cov = block_graph.block_window(cols, B, C)
        prep.update(cand=cand, coverage=cov,
                    mbits=pack_emask(block_graph.block_masks(cols, cand)))
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
        return normalize(fused_gather_attention_plain(h, h, h, cols))
    if route == "gather_kernel":
        return normalize(fused_gather_attention(h, h, h, cols))
    n, d = h.shape
    if route == "block":
        nb = prep["cand"].shape[0]
        return fused_block_attention_packed_shared(
            h.reshape(nb, n // nb, d), h, prep["cand"], prep["mbits"],
            epilogue="l2norm", stable=False).reshape(n, d)
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
