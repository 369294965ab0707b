"""The port's MPRLNetworks against the flax bundle with the same weights:
value and next_state in each branch (separate graph models with the
committed ``mprl_td`` weights; shared graph model, linear state predictor,
goal-frame canonicalization and unicycle kinematics with seeded flax
weights), at rtol 1e-5 (atol 1e-6 for entries near zero). The relation
matrix is a softmax of trained scores up to ~2·10³, whose float32 rounding
moves a weight by more than 1e-5 of itself: it is held at atol 1e-5
(2.6e-6 seen on these inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import MPRLConfig as JMPRL
from relationalgraphlearning_tpu.configs.base import PolicyConfig as JPCfg
from relationalgraphlearning_tpu.models.mprl_networks import (
    MPRLNetworks as JNets)
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs.base import MPRLConfig
from relationalgraphlearning_tpu_torch.configs.base import PolicyConfig
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.models.mprl_networks import (
    MPRLNetworks)

TOL = dict(rtol=1e-5, atol=1e-6)
A_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, B=64, n=5):
    rng = np.random.default_rng(seed)
    robot = np.zeros((B, 9), np.float32)
    robot[:, :2] = rng.uniform(-4, 4, (B, 2))
    robot[:, 2:4] = rng.uniform(-1, 1, (B, 2))
    robot[:, 4] = 0.3
    robot[:, 5:7] = rng.uniform(-4, 4, (B, 2))
    robot[:, 7] = 1.0
    robot[:, 8] = rng.uniform(-np.pi, np.pi, B)
    humans = np.concatenate([rng.uniform(-4, 4, (B, n, 2)),
                             rng.uniform(-1, 1, (B, n, 2)),
                             np.full((B, n, 1), 0.3)], -1).astype(np.float32)
    action = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    return robot, humans, action


def _check(mod, params, net, kinematics):
    robot, humans, action = _inputs()
    js = [jnp.asarray(x) for x in (robot, humans, action)]
    ts = [torch.from_numpy(x) for x in (robot, humans, action)]
    v_j = mod.apply(params, *js[:2], method=JNets.value)
    nr_j, nh_j = mod.apply(params, *js, method=JNets.next_state)
    with torch.no_grad():
        v = net.value(*ts[:2])
        nr, nh = net.next_state(*ts)
    assert v.shape == (64,) and nh.shape == (64, 5, 5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(nr.numpy(), np.asarray(nr_j), **TOL)
    np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), **TOL)
    with torch.no_grad():
        A = net.attention(*ts[:2])
    np.testing.assert_allclose(
        A.numpy(), np.asarray(mod.apply(params, *js[:2],
                                        method=JNets.attention)), **A_TOL)


def test_committed_mprl_td_weights():
    tree = checkpoints.load_flax_tree("mprl_td")
    net = MPRLNetworks(PolicyConfig()).eval()
    net.load_state_dict(mprl_networks_from_flax(tree))
    assert sum(p.numel() for p in net.parameters()) == 33_506
    _check(JNets(JPCfg()), jax.tree.map(jnp.asarray, tree), net, "holonomic")


@pytest.mark.parametrize("branch", [
    dict(share_graph_model=True), dict(linear_state_predictor=True),
    dict(canonicalize=True), dict(canonicalize=True, share_graph_model=True),
    dict(unicycle=True), dict(unicycle=True, canonicalize=True)])
def test_branch_matches_flax(branch):
    branch = dict(branch)
    kinematics = "unicycle" if branch.pop("unicycle", False) else "holonomic"
    cfg_j = JPCfg(mprl=JMPRL(**branch))
    cfg_t = PolicyConfig(mprl=MPRLConfig(**branch))
    mod = JNets(cfg_j, kinematics=kinematics)
    robot, humans, action = _inputs(1, B=1)
    params = mod.init(jax.random.PRNGKey(7), jnp.asarray(robot),
                      jnp.asarray(humans), jnp.asarray(action))
    net = MPRLNetworks(cfg_t, kinematics=kinematics).eval()
    sd = mprl_networks_from_flax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(net.state_dict())
    net.load_state_dict(sd)
    if branch.get("share_graph_model"):
        assert net.pred_graph is net.value_graph_model
    if branch.get("linear_state_predictor"):
        assert net.pred_graph is None
    _check(mod, params, net, kinematics)
