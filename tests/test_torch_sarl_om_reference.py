"""LM-SARL (SARL with occupancy maps) against the benchmark's plain
reference, ``benchmarks/reference/sarl.py``, on seeded random weights: the
rotated rows and the maps, V(s') of every action, the one-step returns and
the chosen action, at a few states of 5 humans and all 81 actions; the
maps' edge cases by hand; and the port's row counters against the FLOP
count's rows, and that count against the nets' layers.

Tolerances: the rows and the maps are the same float32 formulas on both
sides, in the same order, so the counts must agree exactly and the rest
within a few ulps (a cell's mean velocity sums its neighbours in another
order: 1e-6). The value nets multiply the same weights in another layout
(``nn.Linear``'s x·Wᵀ against x·W), so V and the returns agree to float32
rounding over five layers of up to 200 inputs: 1e-5 relative, 1e-6
absolute. An argmax is compared where the top two returns lie 1e-4 apart,
far above that rounding.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import harness  # noqa: E402
from benchmarks.counters import onestep  # noqa: E402
from benchmarks.drivers import common  # noqa: E402
from benchmarks.reference import sarl  # noqa: E402
from relationalgraphlearning_tpu_torch import types as T  # noqa: E402
from relationalgraphlearning_tpu_torch.geometry import (  # noqa: E402
    propagate_full_state)
from relationalgraphlearning_tpu_torch.policies import (  # noqa: E402
    state_transform as st)
from relationalgraphlearning_tpu_torch.policies.factory import (  # noqa: E402
    make_policy)
from relationalgraphlearning_tpu_torch.utils import profiling  # noqa: E402

ROWS_TOL = dict(rtol=1e-6, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-6)
OM = (4, 1.0, 3)


def config() -> dict:
    bench = harness.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["sarl_om"]
    return harness.load_config(entry)


def policies(seed: int = 5):
    """The port's LM-SARL on seeded random weights, and the reference's
    planner holding the same weights."""
    cfg = config()
    port = common.port_config(cfg)
    policy = make_policy("sarl", port.policy, port.env, device="cpu")
    policy.init_params(torch.Generator().manual_seed(seed))
    names, params = zip(*policy.networks.model.named_parameters())
    ref = sarl.OneStep(cfg, common.as_reference(names, params), "cpu")
    return cfg, policy, ref


def states(n_states: int = 6, seed: int = 11):
    """Robots and 5 humans a state, crowded into a few metres so that most
    humans have neighbours in their maps; the last state's first human
    stands still."""
    g = torch.Generator().manual_seed(seed)
    robot = torch.zeros(n_states, 9)
    robot[:, :2] = torch.rand(n_states, 2, generator=g) * 4 - 2
    robot[:, 2:4] = torch.rand(n_states, 2, generator=g) - 0.5
    robot[:, 4], robot[:, 7] = 0.3, 1.0
    robot[:, 5:7] = torch.rand(n_states, 2, generator=g) * 8 - 4
    humans = torch.zeros(n_states, 5, 5)
    humans[..., :2] = torch.rand(n_states, 5, 2, generator=g) * 5 - 2.5
    humans[..., 2:4] = torch.rand(n_states, 5, 2, generator=g) * 2 - 1
    humans[..., 4] = 0.3
    humans[-1, 0, 2:4] = 0.0
    return robot, humans


def test_the_rows_and_maps_are_the_references():
    _, policy, _ = policies()
    robot, humans = states()
    net = policy.networks
    rows = net.rows(robot, humans, net.maps(humans))
    assert rows.shape == (6, 5, 61)
    np.testing.assert_allclose(rows[..., :13], sarl.rotate(robot, humans),
                               **ROWS_TOL)
    want = sarl.occupancy_maps(humans, *OM)
    got = rows[..., 13:]
    np.testing.assert_array_equal(got[..., 0::3], want[..., 0::3])
    np.testing.assert_allclose(got, want, **ROWS_TOL)
    assert want[..., 0::3].sum() > 10  # the states are crowded enough


def test_next_values_returns_and_argmax_are_the_references():
    _, policy, ref = policies()
    robot, humans = states()
    A = 81
    dt = 0.25
    rb = robot[:, None].expand(-1, A, -1)
    hb = humans[:, None].expand(-1, A, -1, -1)
    nr = propagate_full_state(rb, ref.actions.expand(rb.shape[:-1] + (2,)),
                              dt, T.HOLONOMIC)
    nh = torch.cat([hb[..., :2] + hb[..., 2:4] * dt, hb[..., 2:]], -1)
    v = policy.value(nr, nh)
    assert v.shape == (6, A)
    np.testing.assert_allclose(v, ref.value(nr, nh), **NET_TOL)
    got = policy.action_values(T.JointState(robot, humans))
    want = ref.returns(robot, humans)
    np.testing.assert_allclose(got, want, **NET_TOL)
    top2 = torch.topk(want, 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert clear.sum() >= 4
    act = policy.predict(T.JointState(robot, humans))
    ref_act, q = ref.decide(robot, humans)
    np.testing.assert_array_equal(act[clear], ref_act[clear])
    assert float(ref.gap(q, act).max()) == 0.0


def one_state(*humans):
    """One state's humans [1, N, 5] from (px, py, vx, vy) tuples."""
    h = torch.tensor([[*x, 0.3] for x in humans], dtype=torch.float32)
    return h[None]


def both_maps(humans):
    got = st.build_occupancy_maps(humans, *OM)
    want = sarl.occupancy_maps(humans, *OM)
    np.testing.assert_array_equal(got[..., 0::3], want[..., 0::3])
    np.testing.assert_allclose(got, want, **ROWS_TOL)
    return want[0].reshape(humans.shape[1], 16, 3)


def test_a_standing_human_sees_in_the_world_frame():
    # human 0 stands (atan2(0, 0) = 0: x east, y north); its neighbour at
    # (1.5, -0.5) lies in column floor(3.5) = 3, row floor(1.5) = 1
    m = both_maps(one_state((0, 0, 0, 0), (1.5, -0.5, 0.5, 0.25)))
    assert m[0, 1 * 4 + 3].tolist() == [1.0, 0.5, 0.25]
    assert m[0].abs().sum() == 1.75


def test_a_neighbour_on_a_cell_edge_takes_the_upper_cell():
    # edges at -2, -1, 0, 1, 2 m: x = -1 is column 1, y = 0 row 2; an edge
    # at +2 is outside the grid, one at -2 the first cell
    m = both_maps(one_state((0, 0, 0, 0), (-1, 0, 0, 0), (2, 1, 0, 0),
                            (-2, -2, 0, 0)))
    occupied = torch.nonzero(m[0, :, 0]).flatten().tolist()
    assert occupied == [0, 2 * 4 + 1]


def test_neighbours_outside_the_grid_leave_it_empty():
    m = both_maps(one_state((0, 0, 1, 0), (2.5, 0, 0, 0), (0, -3, 0, 0),
                            (-7, 6, 0, 0)))
    assert m[0].abs().sum() == 0


def test_two_neighbours_in_one_cell_count_two_at_their_mean_velocity():
    # human 0 walks north (θ = π/2): a neighbour 0.5 m ahead and 0.3 m to
    # its left in the world lies at x' = 0.5, y' = 0.3 in its frame; its
    # velocity (1, 0) turns to (0, -1), the other's (0, 1) to (1, 0)
    m = both_maps(one_state((0, 0, 0, 1), (-0.3, 0.5, 1, 0),
                            (-0.2, 0.6, 0, 1)))
    cell = 2 * 4 + 2
    np.testing.assert_allclose(m[0, cell], [2.0, 0.5, -0.5], atol=1e-6)
    assert m[0, :, 0].sum() == 2


def test_the_row_counters_are_the_flop_counts_rows():
    cfg, policy, _ = policies()
    robot, humans = states(3)
    profiling.reset()
    profiling.enable()
    try:
        policy.action_values(T.JointState(robot, humans))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    assert onestep.value_rows(cfg) == 81 * 5
    assert counters["plan.value_rows"] == 3 * onestep.value_rows(cfg)
    assert counters["plan.om_rows"] == counters["plan.value_rows"]


def dense(module: nn.Module) -> int:
    return sum(2 * m.in_features * m.out_features for m in module.modules()
               if isinstance(m, nn.Linear))


def test_the_flop_count_is_the_nets_layers():
    cfg, policy, _ = policies()
    net = policy.networks.model
    assert onestep.row_width(cfg) == 61 == net.mlp1.layers[0].in_features
    assert onestep.human_row(cfg) == dense(net.mlp1) + dense(net.mlp2) \
        + dense(net.attention) == 138_500
    assert onestep.action_row(cfg) == dense(net.mlp3) == 67_000
    assert onestep.decision(cfg) == 61_519_500


@pytest.mark.parametrize("with_om", [True, False])
def test_the_phases_leave_the_values_as_they_were(with_om):
    """The lookahead split into its phases gives what the whole net
    gives, with the maps and without."""
    cfg = config()
    cfg["policy"]["with_om"] = with_om
    port = common.port_config(cfg)
    policy = make_policy("sarl", port.policy, port.env, device="cpu")
    policy.init_params(torch.Generator().manual_seed(3))
    robot, humans = states(2)
    js = T.JointState(robot, humans)
    A = 81
    nh = humans[:, None].expand(-1, A, -1, -1)
    nr = robot[:, None].expand(-1, A, -1)
    torch.testing.assert_close(policy._next_values(nr, nh),
                               policy.value(nr, nh), rtol=0, atol=0)
    assert policy.action_values(js).shape == (2, A)
