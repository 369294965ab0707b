"""The port's one-step lookahead policies (CADRL, SARL, SARL with occupancy
maps, LSTM-RL and the model-free RGL) against the JAX package's, with the
committed checkpoints' exported weights, on the reference's own states
along 16 test cases: every action's one-step return (``action_values``,
humans at constant velocity) at rtol 1e-5 / atol 1e-5, and the returns of
the env-queried lookahead (``action_values_env``) at atol 1e-4, since the
env's ORCA sets the humans there (``test_torch_crowd_sim.py``'s bound for
ORCA's float32 LP); the chosen actions equal wherever the best return leads
the second by more than those bounds; SARL's attention weights at 1e-5.
From-scratch weights have the converters' keys and shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu.configs import base as jbase
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.envs import EnvState as JEnvState
from relationalgraphlearning_tpu.envs.scenarios import case_key
from relationalgraphlearning_tpu.policies.factory import (
    make_policy as jmake)
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs import base as tbase
from relationalgraphlearning_tpu_torch.envs.crowd_sim import (
    CrowdSim, EnvState)
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.types import JointState

from mprl_parity import ROOT, to_torch, top2_gap, two_torch_threads  # noqa

TOL = dict(rtol=1e-5, atol=1e-5)
ENV_ATOL = 1e-4
MODELS = {"cadrl": "cadrl", "sarl": "sarl", "sarl_om": "sarl",
          "lstm_rl": "lstm_rl", "rgl": "rgl"}


def _configs(model, query_env=False):
    """(JAX, port) configs of ``results/<model>``, at 5 humans."""
    path = str(ROOT / "results" / model / "config.py")
    out = []
    for base in (jbase, tbase):
        cfg = base.load_config_module(path)
        cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env, sim=dataclasses.replace(
                cfg.env.sim, human_num=5)),
            policy=dataclasses.replace(cfg.policy, query_env=query_env))
        out.append(cfg)
    return out


def _policies(model, query_env=False):
    cfg_j, cfg_t = _configs(model, query_env)
    tree = checkpoints.load_flax_tree(model)
    pol_j = jmake(MODELS[model], cfg_j.policy, cfg_j.env)
    pol_t = make_policy(MODELS[model], cfg_t.policy, cfg_t.env,
                        device="cpu").load_flax(tree)
    return cfg_j, cfg_t, pol_j, jax.tree.map(jnp.asarray, tree), pol_t


def _states(cfg_j, steps=(0, 8, 20)):
    """The reference env's states of 16 test cases after goal-directed
    steps: numpy EnvState fields [len(steps)·16, ...]."""
    env = JCrowdSim(cfg_j.env)

    def roll(i):
        s, _ = env.reset(case_key(0, cfg_j.env.sim.test_seed_offset, i))

        def body(s, _):
            return env.step(s, jnp.asarray([0.15, 0.85])).state, s

        return jax.lax.scan(body, s, None, max(steps) + 1)[1]

    traj = jax.jit(jax.vmap(roll))(jnp.arange(16))
    return [np.asarray(x)[:, list(steps)].reshape((-1,) + x.shape[2:])
            for x in traj]


@pytest.mark.parametrize("model", list(MODELS))
def test_action_values_match_jax(model):
    cfg_j, _, pol_j, params, pol_t = _policies(model)
    states = _states(cfg_j)
    robot, humans = states[0], states[1][..., :5]
    run = jax.jit(jax.vmap(
        lambda r, h: (pol_j.action_values(params, JT.JointState(r, h)),
                      pol_j.predict(params, JT.JointState(r, h),
                                    jax.random.PRNGKey(0), 0.0))))
    want, act_j = map(np.asarray, run(jnp.asarray(robot),
                                      jnp.asarray(humans)))
    js = JointState(*to_torch(robot, humans))
    got = pol_t.action_values(js).numpy()
    assert got.shape == (48, 81)
    np.testing.assert_allclose(got, want, **TOL)
    act = pol_t.predict(js).numpy()
    clear = top2_gap(want) > 1e-4
    assert clear.sum() >= 24  # most states decide clearly
    np.testing.assert_array_equal(act[clear], act_j[clear])


@pytest.mark.parametrize("model", list(MODELS))
def test_action_values_env_match_jax(model):
    cfg_j, cfg_t, pol_j, params, pol_t = _policies(model, query_env=True)
    states = _states(cfg_j)
    env_j = JCrowdSim(cfg_j.env)
    run = jax.jit(jax.vmap(
        lambda s: (pol_j.action_values_env(params, env_j, s),
                   pol_j.predict_env(params, env_j, s, jax.random.PRNGKey(0),
                                     0.0))))
    want, act_j = map(np.asarray, run(JEnvState(*map(jnp.asarray, states))))
    env = CrowdSim(cfg_t.env, device="cpu")
    st = EnvState(*to_torch(*states))
    got = pol_t.action_values_env(env, st).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ENV_ATOL)
    act = pol_t.predict_env(env, st).numpy()
    clear = top2_gap(want) > 4 * ENV_ATOL
    assert clear.sum() >= 24  # most states decide clearly
    np.testing.assert_array_equal(act[clear], act_j[clear])


def test_sarl_attention_weights_match_jax():
    cfg_j, _, pol_j, params, pol_t = _policies("sarl")
    states = _states(cfg_j)
    robot, humans = states[0], states[1][..., :5]
    want = np.asarray(jax.vmap(lambda r, h: pol_j.attention_weights(
        params, JT.JointState(r, h)))(jnp.asarray(robot),
                                      jnp.asarray(humans)))
    got = pol_t.attention_weights(JointState(*to_torch(robot, humans)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cadrl_reads_any_crowd_size():
    """CADRL's single-human net at N = 1 (as it trains) and N = 5 (as it is
    tested): the value is the minimum of the pairwise values."""
    _, _, _, _, pol_t = _policies("cadrl")
    robot, humans = to_torch(*[x for x in _states(_configs("cadrl")[0])[:2]])
    humans = humans[..., :5]
    v5 = pol_t.value(robot, humans)
    v1 = torch.stack([pol_t.value(robot, humans[:, i:i + 1])
                      for i in range(5)], -1)
    torch.testing.assert_close(v5, v1.amin(-1), rtol=0, atol=0)


@pytest.mark.parametrize("model", list(MODELS))
def test_init_has_the_converters_keys(model):
    cfg_j, cfg_t, pol_j, _, _ = _policies(model)
    tree = jax.tree.map(np.asarray, pol_j.init_params(jax.random.PRNGKey(0)))
    pol = make_policy(MODELS[model], cfg_t.policy, cfg_t.env, device="cpu")
    got = pol.init_params(torch.Generator().manual_seed(0)).networks.model \
        .state_dict()
    want = type(pol)._from_flax(tree)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in got.values()) == sum(
        x.size for x in jax.tree.leaves(tree))
    for k, v in got.items():
        if k.endswith("bias"):
            assert (v == 0).all(), k
        elif ".lstm.h" in f".{k}":  # the recurrent kernels: orthogonal
            eye = torch.eye(v.shape[0])
            torch.testing.assert_close(v @ v.T, eye, rtol=0, atol=1e-5)
        else:
            std = 1 / v.shape[1] ** 0.5
            assert abs(float(v.std()) - std) < 0.25 * std, k
            assert float(v.abs().max()) <= 2 * std / 0.8796 + 1e-6, k
    again = pol.init_params(torch.Generator().manual_seed(0)).networks \
        .model.state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
