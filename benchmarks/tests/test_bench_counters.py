"""The FLOP and byte counters against counts worked by hand, and the
planner's count against the port's own counters."""

import pytest
import torch

from benchmarks import harness
from benchmarks.counters import fba, flops
from benchmarks.drivers import common
from benchmarks.counters.peaks import F32_FLOPS, HBM_BYTES

BENCH = harness.load_benchmark()


def config(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return harness.load_config(entry)


def test_an_rgl_forward():
    # w_r 9->64->32, five humans' w_h 5->64->32; per layer on 6 nodes:
    # X·Wa 6·2·32·32, scores 6·6·2·32, H·W 6·2·32·32, A·(HW) 6·6·2·32
    emb = 2 * (9 * 64 + 64 * 32) + 5 * 2 * (5 * 64 + 64 * 32)
    layer = 6 * 2048 + 36 * 64 + 6 * 2048 + 36 * 64
    gcn = config("mp_rgl")["policy"]["gcn"]
    assert flops.rgl_forward(gcn, 5) == emb + 2 * layer == 87_296


def test_the_value_and_predictor_heads():
    cfg = config("mp_rgl")
    rgl = flops.rgl_forward(cfg["policy"]["gcn"], 5)
    assert flops.mprl_value(cfg) == rgl + 2 * (32 * 32 + 32 * 100
                                               + 100 * 100 + 100 * 1)
    assert flops.mprl_predict(cfg) == rgl + 5 * 2 * (32 * 64 + 64 * 5)


def planned(width):
    return common.planned(config("mp_rgl"), {"planning_width": width})


def test_a_decisions_forwards():
    # root: 81 actions' one-step values (81 V, one prediction the 81
    # share); V_planning at depth 2 on the w kept: w V, w·81 V and w
    # predictions; depth 1 on the w² grandchildren: w² V
    assert flops.planner_forwards(config("mp_rgl")) == (81 + 2 + 162 + 4,
                                                       1 + 2)
    assert flops.planner_forwards(planned(4)) == (81 + 4 + 324 + 16, 1 + 4)
    assert config("mp_rgl")["policy"]["mprl"]["planning_width"] == 2


@pytest.mark.parametrize("width", [2, 4])
def test_the_predictor_count_is_the_programs(width):
    """The port's own counters over ``predict`` on B seeded states: the
    predictor's rows a state are the counted predictor forwards, and each
    row serves all 81 actions."""
    from relationalgraphlearning_tpu_torch import types as T
    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)
    from relationalgraphlearning_tpu_torch.utils import profiling
    cfg = planned(width)
    port = common.port_config(cfg)
    torch.manual_seed(width)
    policy = make_policy("model_predictive_rl", port.policy, port.env,
                         device="cpu")
    B = 3
    gen = torch.Generator().manual_seed(97)
    robot = torch.rand((B, 9), generator=gen) * 4 - 2
    robot[:, 4], robot[:, 7] = 0.3, 1.0  # radius, v_pref
    humans = torch.rand((B, 5, 5), generator=gen) * 4 - 2
    humans[..., 4] = 0.3
    profiling.reset()
    profiling.enable()
    try:
        policy.predict(T.JointState(robot, humans))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    _, preds = flops.planner_forwards(cfg)
    assert counters["plan.predictor_states"] == B * preds
    assert counters["plan.predicted_children"] == \
        81 * counters["plan.predictor_states"]


def test_an_sgd_step():
    cfg = config("mp_rgl")
    v, p = flops.mprl_value(cfg), flops.mprl_predict(cfg)
    assert flops.sgd_step(cfg) == 100 * (3 * v + 3 * p + v)


def test_a_crowd_step():
    cfg = config("sparse_rgl_crowd")
    per_agent = (2 * (5 * 64 + 64 * 32)
                 + 2 * (2 * 32 * 32 + 4 * 32 * 16 + 2 * 32 * 32)
                 + 2 * (32 * 32 + 32 * 100 + 100 * 100 + 100))
    assert flops.sparse_rgl_step(cfg) == 10240 * per_agent


def test_kernel_ones_launch():
    n, d, B, C, K = 10240, 32, 256, 576, 16
    nbytes, ops = fba.launch(n, d, B, C, n * K)
    assert nbytes == 4 * n * d * 3 + 8 * 40 * C + 4 * 40 * 8 * C
    assert ops == n * K * (2 * d + 2 * d + 2)
    assert fba.least_seconds(n, d, B, C, n * K) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12))
    assert (F32_FLOPS, HBM_BYTES) == (67e12, 3.35e12)
