"""The reference's judgement of a decision (``Planner.gap``) on a state
where the program's action is the root's best by a margin that lies on the
near-tie band's edge: it reads 0, where a band tested in float32 on one
side and float64 on the other read 1 (the action in no clip tried)."""

import torch

from benchmarks import harness
from benchmarks.drivers import common
from benchmarks.reference import mprl as ref

BENCH = harness.load_benchmark()

# A live state of seed 2147490688's decide cell (decision 867) on the card:
# the robot, the humans' observable states, and the reference's float32
# one-step values v1 and returns Q of its six best actions there (NVIDIA
# H100). The program chose action 14, the best, 1.0014e-5 above the second.
ROBOT = [0.10215675830841064, -2.318345308303833, 0.5043342113494873,
         0.5043342113494873, 0.30000001192092896, 0.0, 4.0, 1.0,
         1.5707963705062866]
HUMANS = [
    [-1.5873993635177612, 0.41538047790527344, 0.7455716729164124,
     -0.6025393009185791, 0.30000001192092896],
    [0.49136343598365784, -1.6212730407714844, -0.1612931191921234,
     0.7677277326583862, 0.30000001192092896],
    [-1.096228837966919, 1.288266658782959, 0.29635465145111084,
     -0.800966203212738, 0.30000001192092896],
    [-0.015372149646282196, 2.0342605113983154, 0.29581964015960693,
     -0.7045233845710754, 0.30000001192092896],
    [1.0319323539733887, 1.0990486145019531, -0.6824166774749756,
     -0.4175795018672943, 0.30000001192092896]]
TOP = {14: (0.36812064051628113, 0.3591890335083008),
       75: (0.36811062693595886, 0.35766786336898804),
       55: (0.36807119846343994, 0.3608109652996063),
       80: (0.36795854568481445, 0.3575695753097534),
       5: (0.36770883202552795, 0.35773971676826477),
       9: (0.36756783723831177, 0.35861042931666703)}


def planner(device="cpu"):
    entry = {c["name"]: c for c in BENCH["configs"]}["mp_rgl"]
    cfg = harness.load_config(entry)
    return ref.Planner(cfg, common.to_device(common.checkpoint_arrays(cfg),
                                             device), device)


def test_the_best_action_on_the_bands_edge_is_planned():
    p = planner()
    v1 = torch.full((1, 81), 0.3)
    q = torch.full((1, 81), 0.35)
    for i, (v, r) in TOP.items():
        v1[0, i], q[0, i] = v, r
    gaps = p.gap(v1.expand(3, 81), q.expand(3, 81), p.actions[[14, 75, 55]])
    # 14 and 75 are the clip (14 kept for sure, 75 alone at the edge); 55,
    # 3.9e-5 below the edge, is in none
    assert gaps.tolist() == [0.0, float(q[0, 14] - q[0, 75]),
                             ref.NOT_PLANNED]


def test_that_states_decision_is_judged_within_the_limit():
    """The same state through the reference on the CPU: the card's action
    (14) and the reference's own are judged within the cell's limit."""
    p = planner()
    robot, humans = torch.tensor([ROBOT]), torch.tensor([HUMANS])
    act, v1, q = p.decide(robot, humans)
    limit = harness.load_traffic({"traffic": "decide_b1"})["check"][
        "limits"]["decision_gap"]
    gaps = p.gap(v1.expand(2, 81), q.expand(2, 81),
                 torch.cat([p.actions[[14]], act]))
    assert float(gaps.max()) <= limit, (gaps, v1[0, [14, 75]])
