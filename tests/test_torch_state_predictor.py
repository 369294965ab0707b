"""The port's StatePredictor and the constant-velocity predictor against
the JAX package's (rtol 1e-5, atol 1e-6), both kinematics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.models import state_predictor as jsp
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.models import state_predictor as tsp

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(16, 9)).astype(np.float32),
            rng.normal(size=(16, 5, 5)).astype(np.float32),
            rng.normal(size=(16, 2)).astype(np.float32))


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_state_predictor_matches_flax(kinematics):
    robot, humans, action = _inputs()
    mod = jsp.StatePredictor(JGCN(), kinematics=kinematics)
    args_j = [jnp.asarray(x) for x in (robot, humans, action)]
    params = mod.init(jax.random.PRNGKey(2), *args_j)
    p = jax.tree.map(np.asarray, params)["params"]
    sd = mprl_networks_from_flax({
        "value_graph_model": p["graph_model"],
        "value_network": {"dense_0": {"kernel": np.zeros((32, 1)),
                                      "bias": np.zeros(1)}},
        "human_motion_predictor": p["human_motion_predictor"]})
    net = tsp.StatePredictor(GCNConfig(), kinematics=kinematics)
    net.load_state_dict({k.replace("value_graph_model", "graph_model"): v
                         for k, v in sd.items()
                         if not k.startswith("value_network")})
    with torch.no_grad():
        nr, nh = net(*(torch.from_numpy(x) for x in (robot, humans, action)))
    nr_j, nh_j = mod.apply(params, *args_j)
    np.testing.assert_allclose(nr.numpy(), np.asarray(nr_j), **TOL)
    np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), **TOL)


@pytest.mark.parametrize("kinematics", ["holonomic", "unicycle"])
def test_linear_state_predictor_matches_jax(kinematics):
    robot, humans, action = _inputs()
    nr, nh = tsp.linear_state_predictor(
        *(torch.from_numpy(x) for x in (robot, humans, action)), 0.25,
        kinematics)
    nr_j, nh_j = jsp.linear_state_predictor(
        *(jnp.asarray(x) for x in (robot, humans, action)), 0.25, kinematics)
    np.testing.assert_allclose(nr.numpy(), np.asarray(nr_j), **TOL)
    np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), **TOL)
    np.testing.assert_allclose(
        tsp.propagate_humans_linear(torch.from_numpy(humans), 0.25).numpy(),
        np.asarray(jsp.propagate_humans_linear(jnp.asarray(humans), 0.25)),
        **TOL)
