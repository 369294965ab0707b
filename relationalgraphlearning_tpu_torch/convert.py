"""Flax → torch weight bridge.

A flax param tree arrives as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``, or ``tree_from_flat`` of a flat
``.npz`` keyed by flax paths); the functions here return a torch
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


def tree_from_flat(flat: Mapping) -> dict:
    """{"params/value_network/dense_0/kernel": array, ...} -> the nested
    dicts of the flax tree."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _rgl(prefix: str, node: Mapping, out: dict) -> None:
    """An RGL's params under ``prefix`` ("" for the module itself, else
    its name with a trailing dot)."""
    _mlp(f"{prefix}w_r", node["w_r"], out)
    _mlp(f"{prefix}w_h", node["w_h"], out)
    if "w_a" in node:
        _dense(f"{prefix}w_a", node["w_a"], out)
    if "w_c" in node:
        _mlp(f"{prefix}w_c", node["w_c"], out)
    i = 1
    while f"gcn_w{i}" in node:
        _dense(f"{prefix}gcn_layers.{i - 1}", node[f"gcn_w{i}"], out)
        i += 1


def rgl_from_flax(tree: Mapping) -> dict:
    """``RGL`` params (``{"params": {...}}`` or the inner dict) -> the
    ``state_dict`` of the port's ``RGL``."""
    out: dict = {}
    _rgl("", tree.get("params", tree), out)
    return out


def mprl_networks_from_flax(tree: Mapping) -> dict:
    """``MPRLNetworks`` params -> the ``state_dict`` of the port's
    ``MPRLNetworks``.

    Names: ``value_graph_model`` and ``pred_graph_model`` (absent when the
    graph model is shared or the predictor linear), each ``w_r``/``w_h``
    (``dense_i``), ``w_a`` (or ``w_c``), ``gcn_w{i}``; ``value_network`` and
    ``human_motion_predictor`` (``dense_i``).
    """
    p = tree.get("params", tree)
    out: dict = {}
    for name in ("value_graph_model", "pred_graph_model"):
        if name in p:
            _rgl(f"{name}.", p[name], out)
    _mlp("value_network", p["value_network"], out)
    if "human_motion_predictor" in p:
        _mlp("human_motion_predictor", p["human_motion_predictor"], out)
    return out
