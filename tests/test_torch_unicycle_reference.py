"""MP-RGL on a unicycle robot against the benchmark's plain reference,
``benchmarks/reference/mprl_unicycle.py``, on seeded random weights: the
81 (v, dθ) actions, one step's propagation and reward from headings that
include turns past ±π, the env step, every action's planning return and
the planner's choice at d=2, w=8; the configuration's file against the
config it is taken from; the value kernel's count against the planner's
value calls at w=2, 4 and 8; and the state predictor's device phase.

Tolerances: the action space, the propagation, the reward and the env
step are the same float32 formulas on both sides, in the same order, so
they agree exactly. The nets multiply the same weights in another layout
(``nn.Linear``'s x·Wᵀ against x·W), so V and the planning returns agree
to float32 rounding over the RGL's two relation layers and the value
network's three (products of up to 100 inputs), carried through two
levels of the tree: 1e-5 relative, 1e-6 absolute. A choice is compared
where the top two returns of the root's clip lie 2e-5 apart and the kept
w lie 2e-5 clear of the next action's one-step value: the returns are
below 1 here, so that is a hundred float32 roundings of them, and the
random weights leave most states' margins between 1e-5 and 1e-3.
"""

import dataclasses
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402
from benchmarks.counters import flops, rgl_value as rgl_count  # noqa: E402
from benchmarks.drivers import common  # noqa: E402
from benchmarks.reference import mprl_unicycle as uni  # noqa: E402
from relationalgraphlearning_tpu_torch import types as T  # noqa: E402
from relationalgraphlearning_tpu_torch.configs.base import (  # noqa: E402
    load_config_module)
from relationalgraphlearning_tpu_torch.envs.crowd_sim import (  # noqa: E402
    CrowdSim, EnvState)
from relationalgraphlearning_tpu_torch.envs.reward import (  # noqa: E402
    compute_reward)
from relationalgraphlearning_tpu_torch.geometry import (  # noqa: E402
    propagate_full_state)
from relationalgraphlearning_tpu_torch.ops import rgl_value as rv  # noqa: E402
from relationalgraphlearning_tpu_torch.policies.action_space import (  # noqa: E402
    build_action_space)
from relationalgraphlearning_tpu_torch.policies.factory import (  # noqa: E402
    make_policy)
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (  # noqa: E402
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training.explorer import (  # noqa: E402
    Explorer)
from relationalgraphlearning_tpu_torch.utils import profiling  # noqa: E402

NET_TOL = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)
CLEAR = 2e-5
# headings a robot reaches after turns: past +π and −π, and past ±2π
HEADINGS = (0.0, 1.5, 3.1, -3.1, 3.6, -3.6, 6.5, -7.0)


def config(width: int = 8) -> dict:
    bench = harness.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["mp_rgl_unicycle"]
    cfg = harness.load_config(entry)
    cfg["policy"]["mprl"]["planning_width"] = width
    return cfg


def policies(width: int = 8, seed: int = 5, device="cpu"):
    """The port's MP-RGL on seeded random weights (biases drawn too), and
    the reference's planner holding the same weights."""
    cfg = config(width)
    port = common.port_config(cfg)
    policy = make_policy("model_predictive_rl", port.policy, port.env,
                         device=device)
    g = torch.Generator().manual_seed(seed)
    policy.init_params(g)
    with torch.no_grad():
        for name, p in policy.networks.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    policy.networks.to(device)
    names, params = zip(*policy.networks.named_parameters())
    planner = uni.Planner(cfg, common.as_reference(names, params), device)
    return cfg, policy, planner


def states(n_states: int = 6, seed: int = 11):
    """Robots at the headings above (cycled) and 5 humans a state within a
    few metres, so that relations and discomfort matter."""
    g = torch.Generator().manual_seed(seed)
    robot = torch.zeros(n_states, 9)
    robot[:, :2] = torch.rand(n_states, 2, generator=g) * 4 - 2
    robot[:, 4], robot[:, 7] = 0.3, 1.0
    robot[:, 5:7] = torch.rand(n_states, 2, generator=g) * 8 - 4
    robot[:, 8] = torch.tensor(HEADINGS * n_states)[:n_states]
    speed = torch.rand(n_states, generator=g)
    robot[:, 2] = speed * torch.cos(robot[:, 8])
    robot[:, 3] = speed * torch.sin(robot[:, 8])
    humans = torch.zeros(n_states, 5, 9)
    humans[..., :2] = torch.rand(n_states, 5, 2, generator=g) * 5 - 2.5
    humans[..., 2:4] = torch.rand(n_states, 5, 2, generator=g) * 2 - 1
    humans[..., 4] = 0.3
    humans[..., 5:7] = -humans[..., :2]
    humans[..., 7] = 1.0
    return robot, humans


def all_actions(robot, actions):
    A = actions.shape[0]
    return (robot[:, None].expand(-1, A, -1),
            actions.expand(robot.shape[0], A, 2))


def test_the_81_actions_are_the_references():
    cfg, policy, planner = policies()
    port = common.port_config(cfg)
    got = build_action_space(port.policy.action_space, 1.0, T.UNICYCLE)
    want = planner.actions.numpy()
    assert got.shape == want.shape == (81, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(policy.action_space.numpy(), want)
    assert want[0].tolist() == [0.0, 0.0]
    c = np.float32(math.pi / 3)
    assert want[1:, 1].min() == -c and want[1:, 1].max() == c
    assert len(set(want[1:, 1].tolist())) == 16
    assert len(set(want[1:, 0].tolist())) == 5


def test_propagation_and_reward_over_headings_past_pi():
    cfg, _, planner = policies()
    robot, humans = states(len(HEADINGS))
    rb, acts = all_actions(robot, planner.actions)
    dt = cfg["env"]["time_step"]
    got = propagate_full_state(rb, acts, dt, T.UNICYCLE)
    want = uni.propagate(rb, acts, dt)
    torch.testing.assert_close(got, want, **EXACT)
    # the heading is not wrapped: past ±π it stays where the turn took it
    assert float(got[..., 8].max()) > math.pi
    assert float(got[..., 8].min()) < -math.pi
    torch.testing.assert_close(got[..., 8], rb[..., 8] + acts[..., 1],
                               **EXACT)
    obs = humans[..., :5]
    hb = obs[:, None].expand(-1, 81, -1, -1)
    t = torch.full(rb.shape[:-1], 24.75)
    env = common.port_config(cfg).env
    r = compute_reward(rb, hb, hb[..., 2:4], acts, t, env)
    w = uni.reward(rb, hb, hb[..., 2:4], acts, t, cfg["env"])
    for name in ("reward", "done", "outcome", "dmin"):
        torch.testing.assert_close(getattr(r, name), getattr(w, name),
                                   **EXACT)
    assert bool((w.dmin < cfg["env"]["reward"]["discomfort_dist"]).any())


def test_the_env_step_is_the_references():
    cfg, _, planner = policies()
    robot, humans = states(len(HEADINGS))
    B = robot.shape[0]
    step = torch.tensor([0, 3, 50, 98, 99, 10, 20, 30], dtype=torch.int32)
    action = planner.actions[torch.arange(B) * 10 % 81]
    env = CrowdSim(common.port_config(cfg).env, device="cpu")
    state = EnvState(robot, humans, step, torch.zeros(B, dtype=torch.bool),
                     torch.zeros(B, dtype=torch.int32))
    out = env.step(state, action)
    want = uni.env_step(robot, humans, step, action, cfg["env"])
    torch.testing.assert_close(out.state.robot, want.robot, **EXACT)
    torch.testing.assert_close(out.state.humans, want.humans, **EXACT)
    torch.testing.assert_close(out.reward, want.reward, **EXACT)
    torch.testing.assert_close(out.done, want.done, **EXACT)
    torch.testing.assert_close(out.outcome, want.outcome, **EXACT)
    assert bool(want.done.any())  # a timeout at step 99


def test_recovered_actions_are_the_steps_and_a_negated_one_is_none():
    cfg, _, planner = policies()
    robot, _ = states(len(HEADINGS))
    dt = cfg["env"]["time_step"]
    idx = torch.arange(len(HEADINGS)) * 7 % 80 + 1
    nxt = uni.propagate(robot, planner.actions[idx], dt)
    got = uni.recover_actions(planner.actions, robot, nxt, dt)
    torch.testing.assert_close(got, planner.actions[idx], **EXACT)
    flipped = uni.propagate(robot, -planner.actions[idx], dt)
    assert bool(uni.recover_actions(planner.actions, robot, flipped,
                                    dt).isnan().all())


def test_action_values_and_choices_are_the_planners_at_w8():
    _, policy, planner = policies()
    robot, humans = states(16)
    obs = humans[..., :5]
    js = T.JointState(robot, obs)
    got = policy.action_values(js)
    v1, q = planner.root(robot, obs)
    assert got.shape == q.shape == (16, 81)
    torch.testing.assert_close(got, q, **NET_TOL)
    # the root's clip keeps the top 8 by one-step value, and the choice
    # is the best of their returns: compared where both are clear
    top = torch.sort(v1, dim=-1, descending=True, stable=True)
    kept_clear = (top.values[:, 7] - top.values[:, 8]) > CLEAR
    best2 = torch.topk(torch.gather(q, -1, top.indices[:, :8]), 2).values
    clear = kept_clear & ((best2[:, 0] - best2[:, 1]) > CLEAR)
    assert int(clear.sum()) >= 8
    act = policy.predict(js)
    ref_act, _, _ = planner.decide(robot, obs)
    torch.testing.assert_close(act[clear], ref_act[clear], **EXACT)
    assert float(planner.gap(v1, q, act).max()) == 0.0


def test_the_configuration_is_the_anneal_config_as_the_port_loads_it():
    cfg = config()
    loaded = dataclasses.asdict(load_config_module(
        str(ROOT / "configs" / "icra_benchmark" / "mp_unicycle_anneal.py")))

    def same(file_group, port_group, path):
        for k, v in file_group.items():
            want = port_group[k]
            if isinstance(v, dict):
                same(v, want, f"{path}.{k}")
                continue
            want = list(want) if isinstance(want, tuple) else want
            assert v == want, f"{path}.{k}: {v!r} != {want!r}"

    for group in ("env", "policy", "train"):
        same(cfg[group], loaded[group], group)
    assert cfg["env"]["robot_kinematics"] == "unicycle"
    assert cfg["policy"]["action_space"]["rotation_constraint"] == \
        math.pi / 3
    assert cfg["policy"]["mprl"]["planning_width"] == 8
    assert (ROOT / cfg["weights"]).exists()


def value_calls(policy, robot, humans):
    """The planner's value calls of one ``predict``, each as the kernel's
    plan of its shapes and strides (the CPU runs the eager value; the
    card's wrapper plans the same tensors)."""
    plans = []
    orig = ModelPredictiveRLPolicy.value

    def value(self, r, h):
        k = r.dim() - 1
        plans.append(rv.plan(r.shape[:-1], r.stride()[:k], h.stride()[:k],
                             h.shape[-2]))
        return orig(self, r, h)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ModelPredictiveRLPolicy, "value", value)
        policy.predict(T.JointState(robot, humans))
    return plans


@pytest.mark.parametrize("width", [2, 4, 8])
def test_the_value_kernels_count_is_the_planners_calls(width):
    """The counter's calls are the planner's, forward for forward; on the
    clip levels its groups are the kernel's (a node's 81 children share
    its prediction), on the gathered levels the tree's w kept children of
    a parent share it where the kernel embeds each forward's humans."""
    cfg, policy, _ = policies(width)
    B = 3
    robot, humans = states(B)
    plans = value_calls(policy, robot, humans[..., :5])
    levels = rgl_count.levels(cfg)
    assert [n * B for _, n, _ in levels] == [p.n for p in plans]
    assert sum(p.n for p in plans) == B * flops.planner_forwards(cfg)[0]
    for (name, n, groups), p in zip(levels, plans):
        if "clip" in name:
            assert (groups * B, n // groups) == (p.groups, p.group_size)
        else:
            assert (p.groups, p.group_size) == (n * B, 1)
            assert n == groups * width
    shared = sum(p.n for p in plans if p.group_size > 1)
    assert shared == B * sum(n for name, n, _ in levels if "clip" in name)
    assert rgl_count.launches(cfg) == len(plans) == 4


def test_the_value_kernels_operations_by_hand():
    # one forward alone: its humans' group and its robot part
    N = 5
    group = N * (5 * 64 + 64 * 32 + 2 * 32 * 32) + N * N * 32
    forward = (9 * 64 + 64 * 32 + 2 * 32 * 32 + 32 * 11 + 32 * 6
               + 32 * 32 + 32 + N * 32 * 8 + 2 * 32 * 32 + 32 * 100
               + 100 * 100 + 100)
    assert rgl_count.call(1, 1, N) == 2 * (group + forward)
    assert rgl_count.call(81, 1, N) == 2 * (group + 81 * forward)
    cfg = config()
    assert [(n, g) for _, n, g in rgl_count.levels(cfg)] == [
        (81, 1), (8, 1), (648, 8), (64, 8)]
    assert rgl_count.decision(cfg) == 2 * (18 * group + 801 * forward)


class PhaseSpy:
    """``profiling.device_phase`` as the planner calls it: each phase's
    name, the phases open around it, and whether profiling was on (on the
    CPU a phase records nothing either way)."""

    def __init__(self):
        self.open, self.seen = [], []

    def __call__(self, name, device):
        spy = self

        class Phase:
            def __enter__(self):
                spy.seen.append((name, tuple(spy.open), profiling.enabled()))
                spy.open.append(name)

            def __exit__(self, *exc):
                spy.open.pop()
                return False
        return Phase()


def eval_steps(on: bool, B: int = 2):
    """One evaluation step of B cases at w=8 on the CPU, profiling on or
    off -> (the step's outputs, the phases the spy saw, the counters)."""
    cfg, policy, _ = policies()
    port = common.port_config(cfg)
    ex = Explorer(CrowdSim(port.env, device="cpu"), policy, port.policy.gamma)
    carry = ex.initial_carry(port.env.sim.test_seed_offset, range(B))
    spy = PhaseSpy()
    profiling.reset()
    if on:
        profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "device_phase", spy)
            with torch.no_grad():
                out = ex.eval_step(*carry)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    return out, spy.seen, counters


def test_the_predictor_phase_nests_in_the_planners_phases():
    """With profiling on, ``plan.predict`` opens twice a step: around the
    root's prediction inside ``plan.root_clip`` and around the 8 kept
    nodes' inside ``plan.v_planning``; 9·B predictor states a step."""
    B = 2
    out_on, seen, counters = eval_steps(True, B)
    predict = [(outer, on) for name, outer, on in seen
               if name == "plan.predict"]
    assert predict == [(("step.plan", "plan.root_clip"), True),
                       (("step.plan", "plan.v_planning"), True)]
    assert counters["plan.predictor_states"] == 9 * B
    assert counters["plan.predicted_children"] == 9 * 81 * B
    # off: the same step, bit for bit, and no phase records (the shared
    # null context), so a graph captured then holds what it held before
    out_off, seen_off, counters_off = eval_steps(False, B)
    for a, b in zip(out_on, out_off):
        torch.testing.assert_close(a, b, **EXACT)
    assert [n for n, _, on in seen_off if not on] == [n for n, _, _ in seen]
    assert counters_off == {}
    assert profiling.device_phase("plan.predict",
                                  torch.device("cuda")) is profiling._NULL


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_the_step_graph_holds_the_same_launches_with_the_phase(dev):
    """The evaluation step at w=8 captured with profiling off and on holds
    the same kernel launches; captured on, a replay reads ``plan.predict``
    twice, apart from the root clip's and ``v_planning``'s times."""
    cfg, policy, _ = policies(device=dev)
    port = common.port_config(cfg)
    graphs = {}
    for on in (False, True):
        ex = Explorer(CrowdSim(port.env, device=dev), policy,
                      port.policy.gamma)
        carry = ex.initial_carry(port.env.sim.test_seed_offset, range(16))
        profiling.reset()
        if on:
            profiling.enable()
        try:
            with torch.no_grad():
                graphs[on] = ex.capture(carry)
                graphs[on](*carry)
            snap = profiling.snapshot()
        finally:
            profiling.disable()
            profiling.reset()
    assert graphs[True].launches == graphs[False].launches
    assert graphs[False].launches["rgl_value"] == 4
    phases = snap["graphs"]["explorer.eval_step"]["phases"]
    assert phases["plan.predict"]["count"] == 2
    assert {"plan.root_clip", "plan.v_planning"} <= set(phases)
    assert 0 < phases["plan.predict"]["ms"] < (
        phases["plan.root_clip"]["ms"] + phases["plan.v_planning"]["ms"])


def brute_gap(planner, v1, q, a, tie=1e-5):
    """The gap by trying every clip set the near tie allows, one by one
    (``reference/mprl.py``'s search)."""
    order = torch.sort(v1, descending=True, stable=True).indices.tolist()
    vals = v1.double().tolist()
    w = planner.width
    edge = vals[order[w - 1]]
    band = tie * max(1.0, abs(edge))
    near = [i for i in order if abs(vals[i] - edge) <= band]
    sure = [i for i in order[:w] if i not in near]
    best = uni.NOT_PLANNED
    for rest in itertools.combinations(near, w - len(sure)):
        clip = sure + list(rest)
        if a in clip:
            best = min(best, float(q[clip].max() - q[a]))
    return best


def test_the_gap_takes_the_least_clip_of_a_near_tie_directly():
    """Where the one-step values tie at the clip's edge, the gap is the
    least over every clip set the tie allows, as a search of them all
    finds it; with 60 tied actions at w=8 (C(60, 8) sets) it still takes
    one sort a state."""
    _, _, planner = policies()
    g = torch.Generator().manual_seed(3)
    v1 = torch.rand(12, 81, generator=g)
    q = torch.rand(12, 81, generator=g)
    for s in range(12):  # 2 to 13 actions tied at the 8th value
        top = torch.sort(v1[s], descending=True).indices
        v1[s, top[6 - s // 2:8 + s // 2 + s % 2]] = float(v1[s, top[7]])
    acts = planner.actions[torch.arange(12) * 7 % 81]
    want = [brute_gap(planner, v1[s], q[s],
                      int(torch.arange(12)[s] * 7 % 81)) for s in range(12)]
    for s in range(12):  # also an action of the tie and one kept for sure
        top = torch.sort(v1[s], descending=True, stable=True).indices
        for a in (int(top[0]), int(top[7]), int(top[9])):
            got = planner.gap(v1[s:s + 1], q[s:s + 1],
                              planner.actions[a][None])
            assert float(got[0]) == brute_gap(planner, v1[s], q[s], a)
    assert planner.gap(v1, q, acts).tolist() == want
    assert any(x == uni.NOT_PLANNED for x in want)
    flat = torch.full((1, 81), 0.5)
    flat[0, :3] = 0.9
    got = planner.gap(flat, q[:1], planner.actions[40][None])
    # the least clip: the 3 kept for sure, action 40, and the 4 tied
    # actions of the lowest returns
    rest = torch.cat([q[0, 3:40], q[0, 41:]])
    clip = torch.cat([q[0, :3], q[0, 40:41], torch.sort(rest).values[:4]])
    assert float(got[0]) == float(clip.max() - q[0, 40])
