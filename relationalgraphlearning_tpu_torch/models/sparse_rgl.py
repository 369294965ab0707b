"""SparseRGL — relation inference + message passing over k-NN agent graphs.

Port of ``relationalgraphlearning_tpu/models/sparse_rgl.py``: embed agents
(``w_h``), embedded-gaussian relation scores against each agent's K nearest
neighbours (``w_a``), softmax-normalised aggregation, then the layer weight
and ``relu``, ``num_layer`` deep. ``SparseValueNet`` adds the per-agent value
head. Parameter names follow the flax tree so ``convert.py`` maps it 1:1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import Tensor, nn

from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.models.mlp import MLP, init_linear_
from relationalgraphlearning_tpu_torch.ops import block_graph, sparse
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    block_attention_fused)
from relationalgraphlearning_tpu_torch.ops.fused_gather import (
    fused_neighbor_attention)

BACKENDS = ("gather", "block", "pallas")


class SparseRGL(nn.Module):
    """``backend`` selects the aggregation implementation (identical math):

    - ``"gather"``: the per-edge fixed-K chain (ops/sparse.py); default.
    - ``"block"``: windowed dense path on spatially sorted nodes with
      ``block_cand`` from ``block_window``. A packed int32 ``block_emask``
      (``pack_emask``) runs the fused CUDA kernel; a bool mask runs
      ``block_graph.block_attention``.
    - ``"pallas"``: the per-edge fused gather kernel (``ops/fused_gather.py``,
      CUDA on the card, the plain chain on the CPU) over ``cols``.
    """

    def __init__(self, cfg: GCNConfig, backend: str = "gather",
                 in_dim: Optional[int] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.cfg = cfg
        self.backend = backend
        in_dim = cfg.human_state_dim if in_dim is None else in_dim
        self.w_h = MLP(in_dim, cfg.wh_dims, last_relu=True)
        h_dim = cfg.wh_dims[-1]
        self.w_a = nn.Linear(h_dim, cfg.final_state_dim, bias=False)
        dims = [cfg.gcn2_w1_dim, cfg.final_state_dim]
        while len(dims) < cfg.num_layer:
            dims.append(cfg.final_state_dim)
        widths = [h_dim, *dims]
        self.gcn_layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=False)
            for i in range(cfg.num_layer))

    def _aggregate(self, H: Tensor, cols: Tensor, mask: Optional[Tensor],
                   layer: nn.Linear, block_cand: Optional[Tensor],
                   block_emask: Optional[Tensor]) -> Tensor:
        """softmax-SDDMM + SpMM for one GCN layer: relu(Â · H · W), with the
        layer weight applied after aggregation (values == keys == H)."""
        q = self.w_a(H)
        if self.backend == "pallas":
            agg = fused_neighbor_attention(q, H, H, cols, mask)
        elif self.backend == "block":
            if block_cand is None:
                raise ValueError("backend='block' needs block_window "
                                 "candidates (block_cand)")
            if block_emask is not None and block_emask.dtype == torch.int32:
                agg = block_attention_fused(q, H, H, block_cand, block_emask)
            else:
                agg = block_graph.block_attention(q, H, H, cols, block_cand,
                                                  mask=mask,
                                                  emask=block_emask)
        else:
            scores = sparse.sddmm_fixed_k(q, H, cols, mask)
            attn = sparse.neighbor_softmax(scores, mask)
            agg = sparse.spmm_fixed_k(attn, H, cols)
        return torch.relu(layer(agg))

    def forward(self, states: Tensor, cols: Tensor,
                mask: Optional[Tensor] = None,
                block_cand: Optional[Tensor] = None,
                block_emask: Optional[Tensor] = None) -> Tensor:
        """states [n, 5], cols [n, K], mask [n, K] → embeddings [n, X_dim].

        On the block backend a precomputed ``block_emask`` must already hold
        any validity mask (``block_masks(cols, cand, mask)``); passing both
        raises there. The gather and pallas backends read ``mask`` and never
        the emask, so they take both. The reference raises on both for
        every backend (``models/sparse_rgl.py:119-124`` of the JAX package).
        """
        if (self.backend == "block" and block_emask is not None
                and mask is not None):
            raise ValueError(
                "backend='block': pass EITHER a precomputed block_emask "
                "(with the validity mask baked in via block_masks(cols, "
                "cand, mask)) OR a per-call mask — a mask beside a "
                "precomputed emask would be ignored.")
        H = self.w_h(states)
        if (self.backend == "block" and block_emask is None
                and block_cand is not None):
            block_emask = block_graph.block_masks(cols, block_cand, mask)
        for layer in self.gcn_layers:
            H_next = self._aggregate(H, cols, mask, layer, block_cand,
                                     block_emask)
            if self.cfg.skip_connection and H_next.shape == H.shape:
                H_next = H_next + H
            H = H_next
        return H


class SparseValueNet(nn.Module):
    """Decentralized per-agent value head over SparseRGL embeddings."""

    def __init__(self, gcn: GCNConfig,
                 value_dims: Sequence[int] = (32, 100, 100, 1),
                 backend: str = "gather",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.graph_model = SparseRGL(gcn, backend=backend)
        self.value_network = MLP(gcn.final_state_dim, value_dims)
        if generator is not None:
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)

    def forward(self, states: Tensor, cols: Tensor,
                mask: Optional[Tensor] = None,
                block_cand: Optional[Tensor] = None,
                block_emask: Optional[Tensor] = None) -> Tensor:
        H = self.graph_model(states, cols, mask, block_cand=block_cand,
                             block_emask=block_emask)
        return self.value_network(H)[..., 0]
