"""RGL, the relational graph model (port of ``relationalgraphlearning_tpu/models/rgl.py``).

Robot state (9) and human states (5) are embedded by the MLPs ``w_r`` and
``w_h`` into node features X [..., N+1, X_dim] with node 0 the robot; a
relation matrix A [..., N+1, N+1] is inferred from the features
(``compute_similarity_matrix``, default ``embedded_gaussian``: the row
softmax of X·W_a·Xᵀ); ``num_layer`` GCN layers take H <- relu(A·H·W). With
``layerwise_graph`` (the default) A is recomputed from H before each layer;
with ``skip_connection`` a layer adds its input when the widths agree.

At n = 6 nodes these are batched matrix products over envs × planning
branches, as in the reference (outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.models.mlp import MLP


def gcn_widths(cfg: GCNConfig) -> list:
    """The output width of each GCN layer: gcn2_w1_dim, then
    final_state_dim."""
    dims = [cfg.gcn2_w1_dim, cfg.final_state_dim]
    while len(dims) < cfg.num_layer:
        dims.append(cfg.final_state_dim)
    return dims[:cfg.num_layer]


class RGL(nn.Module):
    """Parameters named as the flax module's: ``w_r``, ``w_h``, ``w_a`` (or
    ``w_c``), and ``gcn_layers[i]`` for ``gcn_w{i+1}``."""

    def __init__(self, cfg: GCNConfig):
        super().__init__()
        self.cfg = cfg
        self.w_r = MLP(cfg.robot_state_dim, cfg.wr_dims, last_relu=True)
        self.w_h = MLP(cfg.human_state_dim, cfg.wh_dims, last_relu=True)
        x_dim = cfg.wr_dims[-1]
        sim = cfg.similarity_function
        if sim in ("embedded_gaussian", "general"):
            self.w_a = nn.Linear(x_dim, cfg.final_state_dim, bias=False)
        elif sim == "concatenation":
            self.w_c = MLP(2 * x_dim, (cfg.final_state_dim, 1))
        dims = gcn_widths(cfg)
        self.gcn_layers = nn.ModuleList(
            nn.Linear(d_in, d_out, bias=False)
            for d_in, d_out in zip([x_dim] + dims[:-1], dims))

    @property
    def out_dim(self) -> int:
        return gcn_widths(self.cfg)[-1]

    def compute_similarity_matrix(self, X: Tensor) -> Tensor:
        """Relation matrix A [..., n, n] from node features X [..., n, d]."""
        sim = self.cfg.similarity_function
        Xt = X.transpose(-1, -2)
        if sim == "embedded_gaussian":
            return torch.softmax(torch.matmul(self.w_a(X), Xt), dim=-1)
        if sim == "gaussian":
            return torch.softmax(torch.matmul(X, Xt), dim=-1)
        if sim in ("cosine", "cosine_softmax"):
            Xn = X / torch.clamp(torch.sqrt((X * X).sum(-1, keepdim=True)),
                                 min=1e-12)
            scores = torch.matmul(Xn, Xn.transpose(-1, -2))
            return scores if sim == "cosine" else torch.softmax(scores, -1)
        if sim == "squared":
            scores = torch.matmul(X, Xt) ** 2
            return scores / torch.clamp(scores.sum(-1, keepdim=True),
                                        min=1e-12)
        if sim == "equal_attention":
            n = X.shape[-2]
            return torch.full(X.shape[:-1] + (n,), 1.0 / n, dtype=X.dtype,
                              device=X.device)
        if sim == "general":
            return torch.matmul(self.w_a(X), Xt)
        if sim == "concatenation":
            n = X.shape[-2]
            Xi = X[..., :, None, :].expand(*X.shape[:-2], n, n, X.shape[-1])
            Xj = X[..., None, :, :].expand(*X.shape[:-2], n, n, X.shape[-1])
            scores = torch.relu(self.w_c(torch.cat([Xi, Xj], -1)))[..., 0]
            return scores / torch.clamp(scores.sum(-1, keepdim=True),
                                        min=1e-12)
        raise ValueError(f"unknown similarity function: {sim}")

    def forward(self, robot: Tensor, humans: Tensor) -> Tuple[Tensor, Tensor]:
        """robot [..., 9], humans [..., N, 5] -> (node embeddings [..., N+1,
        d], relation matrix A [..., N+1, N+1] of the last propagation)."""
        X = torch.cat([self.w_r(robot)[..., None, :], self.w_h(humans)], -2)
        # with layerwise_graph every layer recomputes A, the first from X
        A = None if self.cfg.layerwise_graph \
            else self.compute_similarity_matrix(X)
        H = X
        for layer in self.gcn_layers:
            if self.cfg.layerwise_graph:
                A = self.compute_similarity_matrix(H)
            H_next = torch.relu(torch.matmul(A, layer(H)))
            if self.cfg.skip_connection and H_next.shape == H.shape:
                H_next = H_next + H
            H = H_next
        return H, A
