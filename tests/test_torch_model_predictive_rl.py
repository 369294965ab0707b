"""The port's MP-RGL planner against the JAX package's, with the committed
weights, on states taken from the JAX policy's own test trajectories:
the clipped root actions exactly, the returns ``predict`` ranks them by at
rtol 1e-5, atol 1e-5 (returns of order 0.1-1 pass through softmaxes of
trained scores up to ~2·10³, whose float32 rounding moves a return by a few
1e-6), and the chosen action equal wherever the top-two gap of the
reference's returns exceeds 1e-4 (float32 sums in another order can swap a
closer pair). At ``mprl_td``'s d=2, w=2, with ``sparse_search``, at d=2,
w=4, and the unicycle model at its own d=2, w=8. ``action_values``, d=1, no
action clip and ties are in ``test_torch_model_predictive_rl_values.py``.
The humans' prediction, shared by a node's actions, is held to the planner
that predicts it per action, in every predictor variant.
"""

import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import (TJointState, TPolicy, configs, policies, predict,
                         root_returns, root_returns_reference, td_states,
                         to_torch, top2_gap, torch_policy,
                         trajectory_states)
from per_action_planner import per_action_expand
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.utils import profiling

TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4


@pytest.fixture(scope="module")
def states():
    return td_states()


@pytest.mark.parametrize("model,overrides", [
    ("mprl_td", {}),
    ("mprl_td", dict(mprl=dict(sparse_search=True))),
    ("mprl_td", dict(mprl=dict(planning_depth=2, planning_width=4))),
    ("mp_unicycle_anneal", {})])
def test_clipped_returns_and_predict(model, overrides, states):
    pol_j, params, pol_t = policies(model, **overrides)
    if model == "mprl_td":
        robot, humans = states
    else:
        robot, humans = trajectory_states(configs(model)[0], pol_j, params)
    assert robot.shape == (64, 9)
    acts_j, ret_j, act_j = root_returns_reference(pol_j)(params, robot,
                                                          humans)
    acts_t, ret_t = root_returns(pol_t, *to_torch(robot, humans))
    # the same clipped actions: no one-step values tie at the cut on these
    # states
    np.testing.assert_array_equal(acts_t.numpy(), acts_j)
    np.testing.assert_allclose(ret_t.numpy(), ret_j, **TOL)
    clear = top2_gap(ret_j) > GAP
    assert clear.sum() >= 32
    np.testing.assert_array_equal(predict(pol_t, robot, humans)[clear],
                                  act_j[clear])


def test_forwards_per_decision_count():
    counts = {}
    for name, ov in (("d2w2", {}), ("d1", dict(planning_depth=1)),
                     ("d2w4", dict(planning_width=4)),
                     ("noclip", dict(do_action_clip=False))):
        _, cfg_t = configs("mprl_td", mprl=ov)
        counts[name] = torch_policy(
            cfg_t, checkpoints.load_flax_tree("mprl_td")
        ).rgl_forwards_per_decision()
    # the root's value forwards and one predictor forward, then each level's
    # nodes, their clip's value forwards and one predictor forward a node
    assert counts == {"d2w2": 82 + 2 + 164 + 4, "d1": 82,
                      "d2w4": 82 + 4 + 328 + 16,
                      "noclip": 1 + 81 + 81 + 81 * 81}


def checkpoint_policy(model, mprl):
    """The port's policy with ``model``'s committed weights, those its nets
    have (no predictor graph when shared, no predictor when linear)."""
    _, cfg_t = configs(model, mprl=mprl)
    pol = TPolicy(cfg_t.policy, cfg_t.env, device="cpu")
    weights = mprl_networks_from_flax(checkpoints.load_flax_tree(model))
    own = pol.networks.state_dict()
    pol.networks.load_state_dict({k: v for k, v in weights.items()
                                  if k in own})
    return pol


# (model, mprl overrides, predictor rows of one decision of ``predict``)
SHARED_CASES = {
    "d2w2": ("mprl_td", {}, 1 + 2),
    "d1": ("mprl_td", dict(planning_depth=1), 1),
    "noclip": ("mprl_td", dict(do_action_clip=False), 1 + 81),
    "share_graph_model": ("mprl_td", dict(share_graph_model=True), 1 + 2),
    "linear_state_predictor": ("mprl_td", dict(linear_state_predictor=True),
                               1 + 2),
    "canonicalize": ("mprl_td", dict(canonicalize=True), 1 + 2),
    "unicycle": ("mp_unicycle_anneal", {}, 1 + 8)}


@pytest.mark.parametrize("case", list(SHARED_CASES))
def test_shared_prediction_equals_the_per_action_expansion(case, states):
    """``_expand`` predicts the humans once a node and shares the result
    with the node's actions: the same next humans as ``next_state`` on the
    broadcast inputs (1e-6), the same action values and choices as the
    planner that predicts them per action (TOL, and exactly wherever the
    top two differ by more than GAP), and the predictor sees the nodes'
    rows, not rows × actions."""
    model, mprl, pred_rows = SHARED_CASES[case]
    pol = checkpoint_policy(model, mprl)
    ref = checkpoint_policy(model, mprl)
    ref._expand = per_action_expand(ref)
    robot, humans = to_torch(*states)
    if not pol.do_action_clip:  # 81² leaves a state: fewer states
        robot, humans = robot[::16], humans[::16]
    acts = pol._all_actions(robot)
    A = acts.shape[-2]
    with torch.no_grad():
        got = pol._expand(robot, humans, acts)
        want = ref._expand(robot, humans, acts)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6)

    js = TJointState(robot, humans)
    values = pol.action_values(js)
    ranked = ref.action_values(js)
    np.testing.assert_allclose(values.numpy(), ranked.numpy(), **TOL)
    if pol.do_action_clip and pol.depth > 1:  # predict ranks clipped ones
        acts_t, ret_t = root_returns(pol, robot, humans)
        acts_r, ranked = root_returns(ref, robot, humans)
        np.testing.assert_array_equal(acts_t.numpy(), acts_r.numpy())
        np.testing.assert_allclose(ret_t.numpy(), ranked.numpy(), **TOL)
    clear = top2_gap(ranked.numpy()) > GAP
    assert clear.any()
    np.testing.assert_array_equal(pol.predict(js).numpy()[clear],
                                  ref.predict(js).numpy()[clear])

    rows = []
    if not pol.cfg.mprl.linear_state_predictor:
        pol.networks.human_motion_predictor.register_forward_hook(
            lambda mod, args, out: rows.append(args[0].shape[:-2].numel()))
    profiling.reset()
    profiling.enable()
    try:
        pol.predict(js)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    B = robot.shape[0]
    assert counters == {"plan.predictor_states": pred_rows * B,
                        "plan.predicted_children": pred_rows * B * A}
    if rows:
        assert sum(rows) == pred_rows * B
