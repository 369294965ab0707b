"""The port's ``Explorer.run_cases`` against the JAX package's.

With the committed weights on the first test cases (8 of ``mprl_td`` at
d=2, w=2 and at d=1; 4 of ``mp_unicycle_anneal`` at its d=2, w=8): each
case's outcome and (for a success) steps equal the reference's per-case
record (``checkpoints/<run>_test_reference.npz``, the JAX package's
``run_cases`` one case at a time), each return agrees at 1e-5, and the
``EvalStats`` of those cases agree with the reference's ``run_cases`` on
the same cases at atol 1e-5 (sums over cases in another order). A holonomic
policy in a unicycle env exercises the action conversion. SARL with the
env-queried lookahead (``query_env``, the policy reading the env's own crowd
step) takes the same decisions as the reference's on 8 cases: outcomes and
steps equal, the statistics at atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs, policies
from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.training.explorer import Explorer as JExplorer
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

ATOL = 1e-5


def _stats_close(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("run,model,overrides,cases", [
    ("mprl_td", "mprl_td", {}, 8),
    ("mprl_td_d1", "mprl_td", dict(mprl=dict(planning_depth=1)), 8),
    ("mp_unicycle_anneal", "mp_unicycle_anneal", {}, 4)])
def test_run_cases_matches_jax_case_by_case(run, model, overrides, cases):
    cfg_j, cfg_t = configs(model, **overrides)
    pol_j, params, pol_t = policies(model, **overrides)
    offset = cfg_t.env.sim.test_seed_offset
    ex = Explorer(CrowdSim(cfg_t.env, device="cpu"), pol_t,
                  cfg_t.policy.gamma)
    final = ex.rollout(offset, range(cases))  # eager on the CPU
    ref = {k: v[:cases] for k, v in
           checkpoints.load_test_reference(run).items()}
    np.testing.assert_array_equal(final.case_outcome.numpy(), ref["outcome"])
    success = ref["outcome"] == JT.OUTCOME_REACH_GOAL
    np.testing.assert_array_equal(final.step.numpy()[success],
                                  ref["steps"][success])
    np.testing.assert_allclose(final.ep_return.numpy(), ref["ret"], rtol=0,
                               atol=ATOL)
    jex = JExplorer(JCrowdSim(cfg_j.env), pol_j, cfg_j.policy.gamma)
    want = jax.jit(lambda p: jex.run_cases(
        p, offset, jnp.arange(cases), jax.random.PRNGKey(1)))(params)
    _stats_close(ex.stats(final), want)


def test_query_env_rollout_matches_jax():
    from relationalgraphlearning_tpu.policies.factory import (
        make_policy as jmake)
    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)

    cfg_j, cfg_t = (dataclasses.replace(c, policy=dataclasses.replace(
        c.policy, query_env=True)) for c in configs("sarl"))
    tree = checkpoints.load_flax_tree("sarl")
    pol_j = jmake("sarl", cfg_j.policy, cfg_j.env)
    pol_t = make_policy("sarl", cfg_t.policy, cfg_t.env,
                        device="cpu").load_flax(tree)
    assert pol_t.query_env
    offset, cases = cfg_t.env.sim.test_seed_offset, 8
    ex = Explorer(CrowdSim(cfg_t.env, device="cpu"), pol_t,
                  cfg_t.policy.gamma)
    final = ex.rollout(offset, range(cases))
    jex = JExplorer(JCrowdSim(cfg_j.env), pol_j, cfg_j.policy.gamma)
    run = jax.jit(lambda p, i: jex.run_cases(p, offset, i,
                                            jax.random.PRNGKey(1)))
    params = jax.tree.map(jnp.asarray, tree)
    for i in range(cases):  # one case a call: its outcome and steps
        s = run(params, jnp.asarray([i]))
        outcome = (JT.OUTCOME_REACH_GOAL if float(s.success_rate) == 1 else
                   JT.OUTCOME_COLLISION if float(s.collision_rate) == 1
                   else JT.OUTCOME_TIMEOUT)
        assert int(final.case_outcome[i]) == outcome, i
        if outcome == JT.OUTCOME_REACH_GOAL:
            assert int(final.step[i]) == round(float(s.avg_nav_time) / 0.25)
    _stats_close(ex.stats(final), run(params, jnp.arange(cases)))


class _Straight:
    """A holonomic policy that walks at 0.9 m/s toward (0.3, 1), in either
    package's calling convention."""

    kinematics = "holonomic"

    def predict(self, *args):
        robot = (args[1] if len(args) == 4 else args[0]).robot
        lib = torch if isinstance(robot, torch.Tensor) else jnp
        v = lib.stack([0.3 * 0.9 + 0 * robot[..., 0],
                       0.9 + 0 * robot[..., 0]], -1)
        return v


def test_holonomic_policy_in_a_unicycle_env_is_converted():
    cfg_j, cfg_t = configs("mp_unicycle_anneal")
    offset = cfg_t.env.sim.test_seed_offset
    ex = Explorer(CrowdSim(cfg_t.env, device="cpu"), _Straight(),
                  cfg_t.policy.gamma, rotation_constraint=np.pi / 3)
    assert ex.convert_to_unicycle and ex.kinematics == "unicycle"
    got = ex.run_cases(offset, range(16))
    jex = JExplorer(JCrowdSim(cfg_j.env), _Straight(), cfg_j.policy.gamma,
                    rotation_constraint=np.pi / 3)
    want = jax.jit(lambda: jex.run_cases(
        None, offset, jnp.arange(16), jax.random.PRNGKey(1)))()
    _stats_close(got, want)


def test_graphed_and_exploring_rollouts_are_refused_where_they_cannot_run():
    _, cfg_t = configs("mprl_td")
    ex = Explorer(CrowdSim(cfg_t.env, device="cpu"), policies("mprl_td")[2],
                  cfg_t.policy.gamma)
    with pytest.raises(ValueError):
        ex.rollout(0, range(2), graphed=True)  # CPU tensors
    with pytest.raises(ValueError):
        ex.rollout(0, range(2), epsilon=0.1)  # no generator
    carry = ex.initial_carry(0, range(3))
    assert [t.shape[0] for t in carry] == [3] * 9
    assert carry.danger_steps.dtype == carry.total_steps.dtype == torch.int32
    nxt = ex.eval_step(*carry, epsilon=1.0,
                       generator=torch.Generator().manual_seed(0))
    assert (nxt[2] == 1).all()  # every case took its first step
