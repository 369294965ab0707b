"""The port's RGL against the flax module with the same weights (through
``convert.rgl_from_flax``), for every similarity option × layerwise_graph ×
skip_connection: node embeddings and relation matrix at rtol 1e-5 (atol
1e-6 for entries that cancel to about zero).

Two options are ill-conditioned in float32 whatever the order of the sums:
``general`` leaves its scores unnormalised, so H grows by orders of
magnitude a layer and small entries are differences of large terms, and
``concatenation`` divides by relu sums that can be near zero. They are held
to 1e-5 of the tensor's largest entry (a norm-wise relative error)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.models.rgl import RGL as JRGL
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.convert import rgl_from_flax
from relationalgraphlearning_tpu_torch.models.rgl import RGL

TOL = dict(rtol=1e-5, atol=1e-6)
ILL_CONDITIONED = ("general", "concatenation")


def _close(got, want, similarity):
    want = np.asarray(want)
    if similarity in ILL_CONDITIONED:
        tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        tol = TOL
    np.testing.assert_allclose(got.numpy(), want, **tol)
SIMILARITIES = ["embedded_gaussian", "gaussian", "cosine", "cosine_softmax",
                "squared", "equal_attention", "general", "concatenation"]


def _inputs(seed=0, B=(4, 3), n=5):
    rng = np.random.default_rng(seed)
    robot = rng.normal(size=B + (9,)).astype(np.float32)
    humans = rng.normal(size=B + (n, 5)).astype(np.float32)
    return robot, humans


def _pair(**kw):
    cfg_j, cfg_t = JGCN(**kw), GCNConfig(**kw)
    robot, humans = _inputs()
    mod = JRGL(cfg_j)
    params = mod.init(jax.random.PRNGKey(3), jnp.asarray(robot),
                      jnp.asarray(humans))
    net = RGL(cfg_t)
    net.load_state_dict(rgl_from_flax(jax.tree.map(np.asarray, params)))
    return mod, params, net, robot, humans


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("layerwise", [True, False])
@pytest.mark.parametrize("similarity", SIMILARITIES)
def test_rgl_matches_flax(similarity, layerwise, skip):
    mod, params, net, robot, humans = _pair(
        similarity_function=similarity, layerwise_graph=layerwise,
        skip_connection=skip)
    H_j, A_j = mod.apply(params, jnp.asarray(robot), jnp.asarray(humans))
    with torch.no_grad():
        H, A = net(torch.from_numpy(robot), torch.from_numpy(humans))
    assert H.shape == (4, 3, 6, 32) and A.shape == (4, 3, 6, 6)
    _close(H, H_j, similarity)
    _close(A, A_j, similarity)


def test_rgl_three_layers_and_other_widths():
    kw = dict(num_layer=3, wr_dims=(48, 24), wh_dims=(40, 24), X_dim=24,
              gcn2_w1_dim=16, final_state_dim=24,
              similarity_function="gaussian")
    mod, params, net, robot, humans = _pair(**kw)
    H_j, A_j = mod.apply(params, jnp.asarray(robot), jnp.asarray(humans))
    with torch.no_grad():
        H, A = net(torch.from_numpy(robot), torch.from_numpy(humans))
    assert net.out_dim == H.shape[-1] == 24
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), **TOL)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), **TOL)
    assert sorted(net.state_dict()) == sorted(rgl_from_flax(
        jax.tree.map(np.asarray, params)))


def test_unknown_similarity_raises():
    net = RGL(dataclasses.replace(GCNConfig(), similarity_function="dot"))
    with pytest.raises(ValueError):
        net(*map(torch.from_numpy, _inputs()))
