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
"""

import numpy as np
import pytest

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import (configs, policies, predict, root_returns,
                         root_returns_reference, td_states, to_torch,
                         top2_gap, torch_policy, trajectory_states)
from relationalgraphlearning_tpu_torch import checkpoints

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
    assert counts == {"d2w2": 162 + 2 + 324 + 4, "d1": 162,
                      "d2w4": 162 + 4 + 648 + 16,
                      "noclip": 162 + 81 * 81 * 2}
