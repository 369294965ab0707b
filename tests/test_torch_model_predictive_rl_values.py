"""The port's MP-RGL planner against the JAX package's: ``action_values``
(every root action's d-step return) at d=2, d=1 and without the action
clip, with the committed ``mprl_td`` weights, at rtol 1e-5, atol 1e-5 (see
``test_torch_model_predictive_rl.py``); the choice of ``predict`` where it
ranks those values (d=1, no clip) wherever the top-two gap exceeds 1e-4;
and ties: equal values pick the lower index first, as ``jax.lax.top_k`` and
``jnp.argmax`` do, in the top-k clip and in ``sparse_search``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import (configs, jax_policy, policies, predict,
                         root_returns, root_returns_reference, td_states,
                         to_torch, top2_gap, torch_policy)
from relationalgraphlearning_tpu import types as JT
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch import types as TT

TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4


@pytest.fixture(scope="module")
def states():
    return td_states()


@pytest.mark.parametrize("overrides", [
    {}, dict(mprl=dict(planning_depth=1)),
    dict(mprl=dict(do_action_clip=False))])
def test_action_values(overrides, states):
    pol_j, params, pol_t = policies("mprl_td", **overrides)
    robot, humans = states
    if not pol_t.do_action_clip:  # 81² leaves a state: fewer states
        robot, humans = robot[::16], humans[::16]
    want = np.asarray(jax.jit(lambda p, r, h: pol_j.action_values(
        p, JT.JointState(r, h)))(params, jnp.asarray(robot),
                                 jnp.asarray(humans)))
    got = pol_t.action_values(TT.JointState(*to_torch(robot, humans)))
    assert got.shape == (robot.shape[0], 81)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if not (pol_t.do_action_clip and pol_t.depth > 1):
        # predict ranks these values: its choice, where the top two differ
        clear = top2_gap(want) > GAP
        assert clear.any()
        np.testing.assert_array_equal(
            predict(pol_t, robot, humans)[clear],
            np.asarray(pol_j.action_space)[want.argmax(-1)][clear])


def _flat_value_tree(model="mprl_td", value=0.5):
    """The committed weights with a value network that outputs ``value``
    everywhere: the planner's scores then tie wherever the rewards do."""
    tree = checkpoints.load_flax_tree(model)
    last = tree["params"]["value_network"]["dense_3"]
    last["kernel"] = np.zeros_like(last["kernel"])
    last["bias"] = np.full_like(last["bias"], value)
    return tree


@pytest.mark.parametrize("sparse", [False, True])
def test_ties_take_the_lower_index(sparse, states):
    ov = dict(mprl=dict(sparse_search=sparse, planning_width=4))
    cfg_j, cfg_t = configs("mprl_td", **ov)
    tree = _flat_value_tree()
    pol_j, params = jax_policy(cfg_j, tree)
    pol_t = torch_policy(cfg_t, tree)
    robot, humans = (x[:16] for x in states)
    # humans far away: every reward 0 (all tie); then the humans as they
    # were: the discomfort penalty breaks some ties and leaves the rest
    far = humans.copy()
    far[..., :2] += 100.0
    reference = root_returns_reference(pol_j)
    for h in (far, humans):
        acts_j, _, act_j = reference(params, robot, h)
        acts_t, _ = root_returns(pol_t, *to_torch(robot, h))
        np.testing.assert_array_equal(acts_t.numpy(), acts_j)
        np.testing.assert_array_equal(predict(pol_t, robot, h), act_j)
    # with every value and reward equal (the first state: the robot far
    # from its goal) the clip keeps the actions 0, 1, 2, 3 in order
    if not sparse:
        acts = root_returns(pol_t, *to_torch(robot[:1], far[:1]))[0]
        np.testing.assert_array_equal(acts[0].numpy(),
                                      pol_t.action_space.numpy()[:4])
