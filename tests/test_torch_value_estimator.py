"""The port's ValueEstimator against the flax module with the same weights
(rtol 1e-5, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.models.value_estimator import (
    ValueEstimator as JValue)
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.models.value_estimator import (
    ValueEstimator)


def test_value_estimator_matches_flax():
    rng = np.random.default_rng(0)
    robot = rng.normal(size=(32, 9)).astype(np.float32)
    humans = rng.normal(size=(32, 5, 5)).astype(np.float32)
    mod = JValue(JGCN())
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(robot),
                      jnp.asarray(humans))
    p = jax.tree.map(np.asarray, params)["params"]
    # the bundle's converter names the graph model value_graph_model
    sd = mprl_networks_from_flax({"value_graph_model": p["graph_model"],
                                  "value_network": p["value_network"]})
    net = ValueEstimator(GCNConfig())
    net.load_state_dict({k.replace("value_graph_model", "graph_model"): v
                         for k, v in sd.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(robot), torch.from_numpy(humans))
    want = mod.apply(params, jnp.asarray(robot), jnp.asarray(humans))
    assert got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
