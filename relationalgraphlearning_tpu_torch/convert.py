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


def _sparse_rgl(prefix: str, g: Mapping, out: dict) -> None:
    _mlp(f"{prefix}w_h", g["w_h"], out)
    _dense(f"{prefix}w_a", g["w_a"], out)
    i = 1
    while f"gcn_w{i}" in g:
        _dense(f"{prefix}gcn_layers.{i - 1}", g[f"gcn_w{i}"], out)
        i += 1


def sparse_rgl_from_flax(tree: Mapping) -> dict:
    """A bare ``SparseRGL``'s params (``{"params": {...}}`` or the inner
    dict: ``w_h/dense_i``, ``w_a``, ``gcn_w{i}``) → the ``state_dict`` of
    the port's ``SparseRGL``, as ``partitioned_block_rgl`` takes it."""
    out: dict = {}
    _sparse_rgl("", tree.get("params", tree), out)
    return out


def sparse_value_net_from_flax(tree: Mapping) -> dict:
    """``SparseValueNet`` params (``{"params": {...}}`` or the inner dict)
    → the ``state_dict`` of the port's ``SparseValueNet``.

    Names: ``graph_model/{w_h/dense_i, w_a, gcn_w{i}}`` and
    ``value_network/dense_i``.
    """
    p = tree.get("params", tree)
    out: dict = {}
    _sparse_rgl("graph_model.", p["graph_model"], out)
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


def cadrl_from_flax(tree: Mapping) -> dict:
    """``CADRLNet`` params -> the ``state_dict`` of the port's ``CADRLNet``
    (``value_network/dense_i``)."""
    out: dict = {}
    _mlp("value_network", tree.get("params", tree)["value_network"], out)
    return out


def sarl_from_flax(tree: Mapping) -> dict:
    """``SARLNet`` params -> the ``state_dict`` of the port's ``SARLNet``
    (``mlp1``, ``mlp2``, ``attention``, ``mlp3``, each ``dense_i``)."""
    p = tree.get("params", tree)
    out: dict = {}
    for name in ("mlp1", "mlp2", "attention", "mlp3"):
        _mlp(name, p[name], out)
    return out


def lstm_rl_from_flax(tree: Mapping) -> dict:
    """``LstmRLNet`` params -> the ``state_dict`` of the port's
    ``LstmRLNet``: the LSTM cell's eight kernels (``ii``..``io`` without
    bias, ``hi``..``ho`` with), ``value_network`` and, with the interaction
    module, ``mlp1``."""
    p = tree.get("params", tree)
    out: dict = {}
    for gate in "ifgo":
        for src in "ih":
            _dense(f"lstm.{src}{gate}", p["lstm"][f"{src}{gate}"], out)
    _mlp("value_network", p["value_network"], out)
    if "mlp1" in p:
        _mlp("mlp1", p["mlp1"], out)
    return out


def value_estimator_from_flax(tree: Mapping) -> dict:
    """``ValueEstimator`` params -> the ``state_dict`` of the port's
    ``ValueEstimator`` (``graph_model`` as an RGL, ``value_network``)."""
    p = tree.get("params", tree)
    out: dict = {}
    _rgl("graph_model.", p["graph_model"], out)
    _mlp("value_network", p["value_network"], out)
    return out


def mprl_train_state_from_flax(tree: Mapping, names: list,
                               learning_rate: float, device="cpu") -> dict:
    """An MP-RGL ``TrainState`` with Adam's state behind the clip
    (``training/trainer.py:31-41`` of the JAX package; nested dicts keyed
    as ``tree_from_flat`` makes them: ``params``, ``target_params``,
    ``opt_state/1/0/{count,mu,nu}``) -> the ``state_dict`` of the port's
    trainer, what its checkpoint ``state.pt`` holds (``training/
    trainer.py``): ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``,
    ``count`` -> ``step``.

    ``names``: the trainer's parameter names in its order (``trainer.names``,
    the nets' ``named_parameters``), the order of its optimizer state. The
    rate is not in the tree (optax holds it in the transform), so the
    caller names the rate the run trained at. Tensors land on ``device``;
    Adam's ``step`` too when Adam is ``capturable`` there (CUDA), else on
    the CPU, as ``training/trainer.make_optimizer`` makes it."""
    device = torch.device(device)
    adam = tree["opt_state"]["1"]["0"]  # (clip, (adam, ...)): the chain

    def tensors(sub: Mapping) -> dict:
        return {k: v.to(device) for k, v in
                mprl_networks_from_flax(sub).items()}

    params, target = tensors(tree["params"]), tensors(tree["target_params"])
    if sorted(params) != sorted(names):
        raise ValueError(f"the tree's parameters {sorted(params)} are not "
                         f"the trainer's {sorted(names)}")
    mu, nu = tensors(adam["mu"]), tensors(adam["nu"])
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32,
                        device=device if device.type == "cuda" else "cpu")
    return {"params": {n: params[n] for n in names},
            "target_params": {n: target[n] for n in names},
            "optimizer": "adam", "learning_rate": learning_rate,
            "optimizer_state": [
                {"step": step.clone(), "exp_avg": mu[n],
                 "exp_avg_sq": nu[n]} for n in names]}
