"""Flax → torch weight bridge.

A flax param tree arrives as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``); the functions here return a torch
``state_dict``. A flax ``Dense.kernel`` is ``[in, out]`` and a torch
``Linear.weight`` is ``[out, in]``, so kernels are transposed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _dense(prefix: str, node: Mapping, out: dict) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.array(node["kernel"], np.float32).T.copy())
    if "bias" in node:
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32))


def _mlp(prefix: str, node: Mapping, out: dict) -> None:
    i = 0
    while f"dense_{i}" in node:
        _dense(f"{prefix}.layers.{i}", node[f"dense_{i}"], out)
        i += 1


def sparse_value_net_from_flax(tree: Mapping) -> dict:
    """``SparseValueNet`` params (``{"params": {...}}`` or the inner dict)
    → the ``state_dict`` of the port's ``SparseValueNet``.

    Names: ``graph_model/{w_h/dense_i, w_a, gcn_w{i}}`` and
    ``value_network/dense_i``.
    """
    p = tree.get("params", tree)
    g = p["graph_model"]
    out: dict = {}
    _mlp("graph_model.w_h", g["w_h"], out)
    _dense("graph_model.w_a", g["w_a"], out)
    i = 1
    while f"gcn_w{i}" in g:
        _dense(f"graph_model.gcn_layers.{i - 1}", g[f"gcn_w{i}"], out)
        i += 1
    _mlp("value_network", p["value_network"], out)
    return out
