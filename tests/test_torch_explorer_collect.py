"""The port's auto-resetting collection against the JAX package's
``Explorer.init_carry`` / ``collect`` / ``update_memory`` /
``count_episodes``.

- The device case table holds what the reference's ``reset`` places for
  the same case keys: the robots bit for bit, every human from the same
  accepted attempt, to the last bit of float32 cos/sin (atol 1e-6), as
  ``test_torch_scenarios.py`` holds the scenarios.
- ``collect`` at B=4 over 12 steps, with a 2 s time limit (8 steps) so
  that every env ends an episode and resets to its next case: with the
  ORCA demonstrator, with MP-RGL at ε = 0 (the committed ``mprl_td``
  weights) and with each one-step baseline at ε = 0 (the committed
  weights of ``sarl``, ``sarl_om``, ``lstm_rl``, ``cadrl`` at its one
  human, and ``rgl``); and on the training paths of ``mp_unicycle`` and
  ``mp_w4``: MP-RGL in ``mp_unicycle``'s env and action space (unicycle,
  ±π/4, the exported ``mp_unicycle`` weights), the ORCA demonstrator in
  that env (its actions turned into feasible unicycle ones, as in
  imitation), and MP-RGL at d=2, w=4 (``mprl_td``'s weights). Every
  trajectory field and the carry agree at 1e-5, 1e-4 where
  ORCA's LP sets the value (the humans' motion, and the demonstrator's
  actions), as ``test_torch_orca.py`` states; flags, outcomes, step and
  case counters exactly.
- ``update_memory``'s Monte-Carlo values and ``valid``, and its TD values,
  on the reference's own trajectory fed to both, at 1e-6, with MP-RGL and
  with CADRL at its one human, and on the three training paths above (the
  demonstrator's in imitation); what lands in the buffer and its ring
  pointer.
- ``count_episodes`` on the same trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs, policies
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.envs.scenarios import case_key
from relationalgraphlearning_tpu.policies.factory import (
    make_policy as jmake)
from relationalgraphlearning_tpu.policies.robot_policies import (
    ORCARobotPolicy as JORCA)
from relationalgraphlearning_tpu.training import replay_buffer as jrb
from relationalgraphlearning_tpu.training.explorer import Explorer as JExplorer
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.policies.robot_policies import (
    ORCARobotPolicy)
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training.explorer import (
    Explorer, Trajectory)

B, STEPS, TIME_LIMIT = 4, 12, 2.0
EXACT = ("terminal", "outcome", "ep_step")
# set by ORCA's LP: the humans' motion always, the robot's under ORCA
LP_FIELDS = ("humans", "next_humans", "dmin", "reward", "ep_return")
LP_ROBOT = ("robot", "action", "next_robot")


def _configs(model="mprl_td", mprl=None):
    cfg_j, cfg_t = configs(model, mprl=mprl)

    def short(cfg):
        return dataclasses.replace(cfg, env=dataclasses.replace(
            cfg.env, time_limit=TIME_LIMIT))

    return short(cfg_j), short(cfg_t)


# the one-step baselines: model -> policy
BASELINES = {"sarl": "sarl", "sarl_om": "sarl", "lstm_rl": "lstm_rl",
             "cadrl": "cadrl", "rgl": "rgl"}


# the training paths of mp_unicycle and mp_w4: kind -> (model of the
# config and weights, planner overrides)
TRAINING_PATHS = {"mp_unicycle": ("mp_unicycle", {}),
                  "orca_unicycle": ("mp_unicycle", {}),
                  "mprl_w4": ("mprl_td", {"planning_width": 4})}


def _explorers(kind):
    model, mprl = TRAINING_PATHS.get(
        kind, (kind if kind in BASELINES else "mprl_td", {}))
    cfg_j, cfg_t = _configs(model, mprl)
    # the demonstrator turns its actions into unicycle ones within the
    # policy's rotation constraint (train_loop.build)
    rot = dict(rotation_constraint=cfg_t.policy.action_space
               .rotation_constraint)
    if kind in BASELINES:
        tree = checkpoints.load_flax_tree(kind)
        pol_j = jmake(BASELINES[kind], cfg_j.policy, cfg_j.env)
        params = jax.tree.map(jnp.asarray, tree)
        pol_t = make_policy(BASELINES[kind], cfg_t.policy, cfg_t.env,
                            device="cpu").load_flax(tree)
    elif kind.startswith("orca"):
        safety = cfg_t.train.orca_safety_space
        pol_j, params = JORCA(cfg_j.policy, cfg_j.env, safety), None
        pol_t = ORCARobotPolicy(cfg_t.policy, cfg_t.env, safety, device="cpu")
    else:
        pol_j, params, pol_t = policies(model, mprl=mprl)
        pol_j.env_cfg = cfg_j.env
        pol_t.env_cfg = cfg_t.env
    jex = JExplorer(JCrowdSim(cfg_j.env), pol_j, cfg_j.policy.gamma, **rot)
    tex = Explorer(CrowdSim(cfg_t.env, device="cpu"), pol_t,
                   cfg_t.policy.gamma, **rot)
    return cfg_t, jex, params, tex


def _jax_collect(jex, params, offset):
    carry = jex.init_carry(B, offset, jax.random.PRNGKey(0))
    return jax.jit(lambda c: jex.collect(params, c, STEPS, jnp.asarray(0.0),
                                         offset))(carry)


def test_case_table_is_the_references_reset():
    cfg_j, cfg_t = _configs()
    offset = cfg_t.env.sim.train_seed_offset
    tex = Explorer(CrowdSim(cfg_t.env, device="cpu"), None, 0.9)
    table = tex.case_table(offset)
    table.ensure(40)
    assert table.capacity >= 40
    states, _ = jax.jit(jax.vmap(JCrowdSim(cfg_j.env).reset))(
        jax.vmap(lambda i: case_key(0, offset, i))(jnp.arange(40)))
    np.testing.assert_array_equal(table.robot[:40].numpy(),
                                  np.asarray(states.robot))
    np.testing.assert_allclose(table.humans[:40].numpy(),
                               np.asarray(states.humans), rtol=0, atol=1e-6)
    cap = table.capacity
    table.ensure(cap + 1)  # grows by doubling and keeps what it had
    assert table.capacity == 2 * cap
    np.testing.assert_array_equal(table.robot[:40].numpy(),
                                  np.asarray(states.robot))


@pytest.mark.parametrize("kind", ["orca", "mprl", "sarl", "sarl_om",
                                  "lstm_rl", "cadrl", "rgl", *TRAINING_PATHS])
def test_collect_with_auto_reset_matches_jax(kind):
    cfg_t, jex, params, tex = _explorers(kind)
    offset = cfg_t.env.sim.train_seed_offset
    jcarry, jtraj = _jax_collect(jex, params, offset)
    carry, traj = tex.collect(tex.init_carry(B, offset), STEPS, offset)
    assert traj.robot.shape == (STEPS, B, 9)
    term = np.asarray(jtraj.terminal)
    assert term.any(0).all()  # every env ended an episode and reset
    assert (np.asarray(jtraj.ep_step)[term.argmax(0) + 1,
                                      np.arange(B)] == 0).all()
    for field, got, want in zip(Trajectory._fields, traj, jtraj):
        got, want = got.numpy(), np.asarray(want)
        if field in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=field)
        else:
            lp = field in LP_FIELDS or (kind.startswith("orca")
                                        and field in LP_ROBOT)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 if lp else 1e-5,
                                       err_msg=field)
    np.testing.assert_array_equal(carry.case_counter.numpy(),
                                  np.asarray(jcarry.case_counter))
    np.testing.assert_array_equal(carry.ep_step.numpy(),
                                  np.asarray(jcarry.ep_step))
    np.testing.assert_allclose(carry.robot.numpy(),
                               np.asarray(jcarry.env_states.robot),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(carry.humans.numpy(),
                               np.asarray(jcarry.env_states.humans),
                               rtol=0, atol=1e-4)
    # the eager loop and a second iteration continue the same envs
    carry2, traj2 = tex.collect(carry, 4, offset, graphed=False)
    assert torch.equal(traj2.robot[0], carry.robot)
    with pytest.raises(ValueError):
        tex.collect(carry, 4, offset, graphed=True)  # CPU tensors
    with pytest.raises(ValueError):
        tex.collect(carry, 4, offset, epsilon=0.5)  # no draws


def _traj_to_torch(jtraj):
    return Trajectory(*(torch.from_numpy(np.array(a)) for a in jtraj))


MEMORY_CASES = [(True, "mprl"), (True, "cadrl"), (False, "mprl"),
                (False, "cadrl"), (False, "mp_unicycle"),
                (True, "orca_unicycle"), (False, "mprl_w4")]


@pytest.mark.parametrize("imitation,kind", [
    pytest.param(i, k, id=f"{i}-{k}") for i, k in MEMORY_CASES])
def test_update_memory_targets_match_jax(imitation, kind):
    cfg_t, jex, params, tex = _explorers(kind)
    # imitation reads no value (the demonstrator has none)
    pol_j, pol_t = jex.policy, tex.policy
    value_j, value_t = ((None, None) if imitation
                        else (pol_j.value, pol_t.value))
    offset = cfg_t.env.sim.train_seed_offset
    _, jtraj = _jax_collect(jex, params, offset)
    n = cfg_t.env.sim.human_num
    cap = STEPS * B + 4  # the ring wraps on the second push
    jbuf = jrb.push(jrb.create(cap, n), jax.tree.map(
        lambda a: a[:8], jrb.create(8, n).data))
    jbuf = jex.update_memory(jbuf, jtraj, value_j, params, imitation)
    tbuf = rb.push(rb.create(cap, n, device="cpu"),
                   rb.create(8, n, device="cpu").data)
    tex.update_memory(tbuf, _traj_to_torch(jtraj), value_t, imitation)
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
    for field, got, want in zip(rb.Transition._fields, tbuf.data, jbuf.data):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=field)
    valid = tbuf.data.valid.numpy()
    if imitation:  # the trailing episode of each env has no target
        assert 0 < valid.sum() < STEPS * B
    else:
        assert valid.sum() == STEPS * B


def test_count_episodes_matches_jax():
    cfg_t, jex, params, tex = _explorers("orca")
    offset = cfg_t.env.sim.train_seed_offset
    _, jtraj = _jax_collect(jex, params, offset)
    want = jex.count_episodes(jtraj)
    got = tex.count_episodes(_traj_to_torch(jtraj))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(got["episodes"]) >= B
