"""The FLOP and byte counters against counts worked by hand."""

import pytest

from benchmarks import harness
from benchmarks.counters import fba, flops
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


def test_a_decisions_forwards():
    # root: 81 actions' one-step values (81 V, 81 predictions); V_planning
    # at depth 2 on the 2 kept: 2 V, 2·81 V and 2·81 predictions; depth 1
    # on the 4 grandchildren: 4 V
    assert flops.planner_forwards(config("mp_rgl")) == (81 + 2 + 162 + 4,
                                                       81 + 162)


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
