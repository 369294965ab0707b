"""Value networks of the one-step baselines (port of
``relationalgraphlearning_tpu/models/baseline_nets.py``).

Each reads the rotated rows of ``policies/state_transform.py`` ([..., N, D],
one a human, the robot's 6 values first) and broadcasts over leading batch
dimensions:

- ``CADRLNet``: the pairwise MLP on each row, then the minimum over the
  humans (the reference evaluates its single-human net once a human and
  keeps the worst value; at N = 1 the minimum is the value);
- ``SARLNet``: ``mlp1`` → ``mlp2`` features, attention scores from ``mlp1``'s
  output (with their mean over the humans, the global state, beside it),
  the softmax-weighted sum of the features joined to the robot's 6 values
  → ``mlp3``; it returns the value and the attention weights;
- ``LstmRLNet``: the humans' rows sorted by decreasing distance, run through
  an LSTM cell from a zero carry, the last hidden state joined to the
  robot's 6 values → the value MLP.

The LSTM cell is flax's ``OptimizedLSTMCell`` written out with
``nn.Linear``s named as its parameters (``ii``/``if``/``ig``/``io`` from the
input, no bias; ``hi``/``hf``/``hg``/``ho`` from the hidden state, with
bias), so a flax tree loads one to one and no cuDNN weight packing enters a
captured graph. The products stay ``nn.Linear``/``torch.matmul``: no
kernel of the port lies on this path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from relationalgraphlearning_tpu_torch.models.mlp import MLP
from relationalgraphlearning_tpu_torch.policies.state_transform import (
    ROTATED_ROBOT_DIM)

GATES = ("i", "f", "g", "o")


class CADRLNet(nn.Module):
    def __init__(self, in_dim: int,
                 mlp_dims: Sequence[int] = (150, 100, 100, 1)):
        super().__init__()
        self.value_network = MLP(in_dim, mlp_dims)

    def forward(self, rows: Tensor) -> Tensor:
        """rows [..., N, D] -> the value [...], the minimum over humans."""
        vals = self.value_network(rows)[..., 0]
        return vals.amin(-1) if rows.dim() >= 2 else vals


class SARLNet(nn.Module):
    def __init__(self, in_dim: int, mlp1_dims: Sequence[int] = (150, 100),
                 mlp2_dims: Sequence[int] = (100, 50),
                 attention_dims: Sequence[int] = (100, 100, 1),
                 mlp3_dims: Sequence[int] = (150, 100, 100, 1),
                 with_global_state: bool = True):
        super().__init__()
        self.with_global_state = with_global_state
        self.mlp1 = MLP(in_dim, mlp1_dims, last_relu=True)
        self.mlp2 = MLP(mlp1_dims[-1], mlp2_dims)
        self.attention = MLP(mlp1_dims[-1] * (2 if with_global_state else 1),
                             attention_dims)
        self.mlp3 = MLP(ROTATED_ROBOT_DIM + mlp2_dims[-1], mlp3_dims)

    def forward(self, rows: Tensor) -> tuple[Tensor, Tensor]:
        """rows [..., N, D] -> (value [...], attention weights [..., N])."""
        self_state = rows[..., 0, :ROTATED_ROBOT_DIM]
        e = self.mlp1(rows)
        h = self.mlp2(e)
        attn_in = e
        if self.with_global_state:
            attn_in = torch.cat([e, e.mean(-2, keepdim=True).expand(e.shape)],
                                -1)
        weights = torch.softmax(self.attention(attn_in)[..., 0], -1)
        weighted = (weights[..., None] * h).sum(-2)
        value = self.mlp3(torch.cat([self_state, weighted], -1))[..., 0]
        return value, weights


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: gates (i, f, g, o) = σ, σ, tanh, σ of
    (h·W_h + b_h) + x·W_i; c' = f·c + i·g, h' = o·tanh(c')."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in GATES:
            self.add_module(f"i{gate}", nn.Linear(in_dim, hidden, bias=False))
            recurrent = nn.Linear(hidden, hidden)
            recurrent.recurrent = True  # orthogonal in models/init.py
            self.add_module(f"h{gate}", recurrent)

    def _stacked(self, prefix: str, attr: str) -> Tensor:
        return torch.cat([getattr(self._modules[prefix + g], attr)
                          for g in GATES])

    def forward(self, xs: Tensor) -> Tensor:
        """The sequence xs [..., T, D] from a zero carry -> the last hidden
        state [..., hidden]. The input products of all T steps run as one,
        as do the four gates' products of each step."""
        x_proj = xs @ self._stacked("i", "weight").T  # [..., T, 4·hidden]
        w_h = self._stacked("h", "weight")
        b_h = self._stacked("h", "bias")
        c = h = xs.new_zeros(xs.shape[:-2] + (self.hidden,))
        for t in range(xs.shape[-2]):
            z = torch.nn.functional.linear(h, w_h, b_h) + x_proj[..., t, :]
            i, f, g, o = z.chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


class LstmRLNet(nn.Module):
    def __init__(self, human_dim: int, lstm_hidden_dim: int = 50,
                 mlp_dims: Sequence[int] = (150, 100, 100, 1),
                 with_interaction_module: bool = False,
                 mlp1_dims: Sequence[int] = (150, 100, 100, 50)):
        super().__init__()
        if with_interaction_module:
            self.mlp1 = MLP(human_dim, mlp1_dims, last_relu=True)
            human_dim = mlp1_dims[-1]
        self.lstm = LSTMCell(human_dim, lstm_hidden_dim)
        self.value_network = MLP(ROTATED_ROBOT_DIM + lstm_hidden_dim,
                                 mlp_dims)

    def forward(self, rows: Tensor) -> Tensor:
        """rows [..., N, D] -> the value [...]."""
        self_state = rows[..., 0, :ROTATED_ROBOT_DIM]
        human_rows = rows[..., ROTATED_ROBOT_DIM:]
        # farthest first: the reverse of the stable ascending sort of the
        # distances (column 5), as jnp.flip(jnp.argsort(da)) orders ties
        order = torch.argsort(human_rows[..., 5], dim=-1, stable=True).flip(-1)
        sorted_rows = torch.gather(
            human_rows, -2,
            order[..., None].expand(order.shape + human_rows.shape[-1:]))
        if hasattr(self, "mlp1"):
            sorted_rows = self.mlp1(sorted_rows)
        h = self.lstm(sorted_rows)
        return self.value_network(torch.cat([self_state, h], -1))[..., 0]
