"""The port's robot policies without parameters against the JAX package's
on the same states: the ORCA demonstrator (safety space 0.15) at atol
1e-4 with the humans 1-3 m from the robot (ORCA's LP, as
``test_torch_orca.py`` states), and in float64 at 1e-9 among overlapping
humans, where float32 rounding grows to ~1e-3 in either package; the
linear policy at 1e-6 and the social-force robot at 1e-5; the registry;
and the holonomic→unicycle conversion of the demonstrator's actions inside a
unicycle-configured env (``explorer.py:88-105``), over a collection whose
headings turn, at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs
from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.policies import robot_policies as jrp
from relationalgraphlearning_tpu.training.explorer import Explorer as JExplorer
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies import robot_policies as trp
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.training.explorer import Explorer


def _states(seed=0, B=128, n=5, near=(1.0, 3.0), dtype=np.float32):
    """Robots heading for their goals among humans at a distance in
    ``near`` (m) from them."""
    rng = np.random.default_rng(seed)
    robot = np.zeros((B, 9), np.float32)
    robot[:, :2] = rng.uniform(-4, 4, (B, 2))
    robot[:, 2:4] = rng.uniform(-1, 1, (B, 2))
    robot[:, 4] = 0.3
    robot[:, 5:7] = rng.uniform(-4, 4, (B, 2))
    robot[:5, 5:7] = robot[:5, :2]  # at the goal: zero preferred velocity
    robot[:, 7] = 1.0
    robot[:, 8] = rng.uniform(-np.pi, np.pi, B)
    angle = rng.uniform(0, 2 * np.pi, (B, n))
    dist = rng.uniform(*near, (B, n))
    pos = robot[:, None, :2] + dist[..., None] * np.stack(
        [np.cos(angle), np.sin(angle)], -1)
    humans = np.concatenate([pos, rng.uniform(-1, 1, (B, n, 2)),
                             np.full((B, n, 1), 0.3)], -1)
    return robot.astype(dtype), humans.astype(dtype)


def _both(cls_j, cls_t, states=None, **kw):
    cfg_j, cfg_t = configs("mprl_td")
    robot, humans = states or _states()
    pol_j = cls_j(cfg_j.policy, cfg_j.env, **kw)
    pol_t = cls_t(cfg_t.policy, cfg_t.env, device="cpu", **kw)
    want = jax.jit(jax.vmap(lambda r, h: pol_j.predict(
        None, JT.JointState(r, h), jax.random.PRNGKey(0), 0.0)))(
        jnp.asarray(robot), jnp.asarray(humans))
    got = pol_t.predict(T.JointState(torch.from_numpy(robot),
                                     torch.from_numpy(humans)))
    assert got.shape == (robot.shape[0], 2)
    return got.numpy(), np.asarray(want)


def test_orca_demonstrator_matches_jax():
    got, want = _both(jrp.ORCARobotPolicy, trp.ORCARobotPolicy,
                      safety_space=0.15)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want).max() > 0.5  # it moves


def test_orca_demonstrator_matches_jax_float64_among_overlapping_humans():
    states = _states(1, near=(0.0, 1.5), dtype=np.float64)
    with jax.enable_x64(True):
        got, want = _both(jrp.ORCARobotPolicy, trp.ORCARobotPolicy,
                          states=states, safety_space=0.15)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_linear_policy_matches_jax():
    got, want = _both(jrp.LinearPolicy, trp.LinearPolicy)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:5], 0.0)  # already at the goal


def test_social_force_robot_matches_jax():
    got, want = _both(jrp.SocialForceRobotPolicy,
                      trp.SocialForceRobotPolicy)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_registry_names_what_is_ported():
    _, cfg = configs("mprl_td")
    for name, cls in (("orca", trp.ORCARobotPolicy),
                      ("linear", trp.LinearPolicy),
                      ("socialforce", trp.SocialForceRobotPolicy)):
        assert isinstance(make_policy(name, cfg.policy, cfg.env,
                                      device="cpu"), cls)
    assert make_policy("model_predictive_rl", cfg.policy, cfg.env,
                       device="cpu").trainable
    from relationalgraphlearning_tpu.policies.factory import (
        policy_factory as jax_factory)
    from relationalgraphlearning_tpu_torch.policies import one_step
    from relationalgraphlearning_tpu_torch.policies.factory import (
        policy_factory)

    assert sorted(policy_factory) == sorted(jax_factory)
    for name, cls in (("cadrl", one_step.CADRLPolicy),
                      ("sarl", one_step.SARLPolicy),
                      ("lstm_rl", one_step.LstmRLPolicy),
                      ("gcn", one_step.GCNPolicy),
                      ("rgl", one_step.GCNPolicy)):
        pol = make_policy(name, cfg.policy, cfg.env, device="cpu")
        assert isinstance(pol, cls) and pol.trainable
    with pytest.raises(KeyError):
        make_policy("nope", cfg.policy, cfg.env, device="cpu")


def test_demonstrator_in_a_unicycle_env_is_converted_as_jax_does():
    cfg_j, cfg_t = configs("mp_unicycle_anneal")
    rc = cfg_t.policy.action_space.rotation_constraint
    offset = cfg_t.env.sim.train_seed_offset
    demo_j = jrp.ORCARobotPolicy(cfg_j.policy, cfg_j.env, 0.15)
    demo_t = trp.ORCARobotPolicy(cfg_t.policy, cfg_t.env, 0.15, device="cpu")
    jex = JExplorer(JCrowdSim(cfg_j.env), demo_j, cfg_j.policy.gamma,
                    rotation_constraint=rc)
    tex = Explorer(CrowdSim(cfg_t.env, device="cpu"), demo_t,
                   cfg_t.policy.gamma, rotation_constraint=rc)
    assert tex.convert_to_unicycle and tex.kinematics == T.UNICYCLE
    carry = jex.init_carry(4, offset, jax.random.PRNGKey(0))
    _, jtraj = jax.jit(lambda c: jex.collect(None, c, 12, jnp.asarray(0.0),
                                             offset))(carry)
    _, traj = tex.collect(tex.init_carry(4, offset), 12, offset)
    theta = traj.next_robot[..., T.THETA] - traj.robot[..., T.THETA]
    assert float(theta.abs().max()) > 0.05  # the headings turn
    assert float(theta.abs().max()) <= rc + 1e-6
    for field in ("robot", "next_robot"):
        np.testing.assert_allclose(getattr(traj, field).numpy(),
                                   np.asarray(getattr(jtraj, field)),
                                   rtol=0, atol=1e-4, err_msg=field)
    # the trajectory records the demonstrator's holonomic action
    np.testing.assert_allclose(traj.action.numpy(), np.asarray(jtraj.action),
                               rtol=0, atol=1e-4)
