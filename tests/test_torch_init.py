"""The port's from-scratch initialisation against flax's defaults: the
state dict of ``ModelPredictiveRLPolicy.init_params`` has exactly the keys
and shapes that ``convert.mprl_networks_from_flax`` makes of the JAX
package's ``init_params`` (and loads them strictly), every bias is zero,
and every kernel is flax's ``lecun_normal``: a standard deviation within
10 % of 1/√fan_in and no entry beyond 2σ of the untruncated normal
(σ = 1/(√fan_in · 0.8796)). The same seed gives the same weights; another
seed others."""

import math

import jax
import numpy as np
import pytest
import torch

from mprl_parity import configs
from relationalgraphlearning_tpu.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy as JPolicy)
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)

VARIANTS = {"separate": {}, "shared": dict(share_graph_model=True),
            "linear": dict(linear_state_predictor=True)}


def _policies(variant, seed=0):
    cfg_j, cfg_t = configs("mprl_td", mprl=VARIANTS[variant])
    tree = jax.tree.map(np.asarray, JPolicy(cfg_j.policy, cfg_j.env)
                        .init_params(jax.random.PRNGKey(seed)))
    pol = ModelPredictiveRLPolicy(cfg_t.policy, cfg_t.env, device="cpu")
    return tree, pol.init_params(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_state_dict_has_the_converters_keys(variant):
    tree, pol = _policies(variant)
    want = mprl_networks_from_flax(tree)
    got = pol.networks.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    pol.networks.load_state_dict(want, strict=True)
    n_j = sum(x.size for x in jax.tree.leaves(tree))
    assert sum(v.numel() for v in got.values()) == n_j
    if variant == "separate":
        assert n_j == 33_506  # mp_separate's nets, as the reference logs


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_biases_are_zero_and_kernels_are_truncated_lecun_normal(variant):
    tree, pol = _policies(variant)
    kernels = 0
    for name, layer in pol.networks.named_modules():
        if not isinstance(layer, torch.nn.Linear):
            continue
        kernels += 1
        if layer.bias is not None:
            assert not layer.bias.any(), name
        w = layer.weight.detach().double()
        fan_in = layer.in_features
        sigma = 1 / math.sqrt(fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * sigma, name
        assert abs(float(w.std()) * math.sqrt(fan_in) - 1) < 0.10, name
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert kernels == sum(p[-1].key == "kernel" for p, _ in paths)


def test_the_seed_decides_the_weights():
    _, a = _policies("separate", 0)
    _, b = _policies("separate", 0)
    _, c = _policies("separate", 1)
    for (k, x), y, z in zip(a.networks.state_dict().items(),
                            b.networks.state_dict().values(),
                            c.networks.state_dict().values()):
        assert torch.equal(x, y), k
        if k.endswith("weight"):
            assert not torch.equal(x, z), k


def test_train_and_eval_toggle_the_parameters():
    _, pol = _policies("separate")
    params = list(pol.networks.parameters())
    assert not any(p.requires_grad for p in params)  # evaluation: frozen
    assert pol.train() is pol
    assert all(p.requires_grad for p in params) and pol.networks.training
    pol.eval()
    assert not any(p.requires_grad for p in params)
    assert not pol.networks.training
