"""MP-RGL's value kernel (``ops/rgl_value.py``, ``csrc/rgl_value.cu``).

On the CPU: the planner's ``value`` is ``networks.value`` bit for bit and
launches nothing; ``plan`` reads which leading dimension shares the humans
from the strides of the planner's own views and tiles the forwards; the
config check accepts every MP-RGL configuration of the port and raises on
another graph; the wrapper raises in grad mode and on CPU tensors. The
kernel's source, built with the host compiler against a stub CUDA runtime
(``tests/cuda_stub``: a block's threads as host threads, ``__syncthreads``
a barrier), holds its arithmetic to ``networks.value`` on the planner's
shapes.

On the card (marker ``cuda``): the kernel against ``MPRLNetworks.value`` on
the committed ``mprl_td`` weights and states of its test cases: the root
clip's [1, 81] and [500, 81] children (stride-0 humans), the leaves'
[500, 2, 2] (gathered), 5 and 10 humans, ``canonicalize``,
``share_graph_model``, the unicycle model (w=8), after an in-place Adam
step, and inside a captured CUDA graph replayed after the parameters
change; the planner's choice against the eager planner's away from near
ties; the raises; and the counters and launches of one ``predict``.
Float32 tolerance: the kernel sums in another order than cuBLAS (FMA
chains of 32 to 100 terms, the second layer's softmax online), so the two
differ by float32 rounding, ~1e-6 of |V| here; TOL allows 1e-5 (the
planner tests' tolerance). Card tests import neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_rgl_value_kernel.py --noconftest -m cuda
"""

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from relationalgraphlearning_tpu_torch import captured, checkpoints
from relationalgraphlearning_tpu_torch import types as TT
from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.ops import rgl_value as rv
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training.explorer import (
    EvalCarry, Explorer)
from relationalgraphlearning_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-5   # the benchmark's near-tie band (relative)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _config(model="mprl_td", **mprl):
    config = load_config_module(str(ROOT / "results" / model / "config.py"))
    if mprl:
        policy = dataclasses.replace(config.policy, mprl=dataclasses.replace(
            config.policy.mprl, **mprl))
        config = dataclasses.replace(config, policy=policy)
    return config


def _policy(device, model="mprl_td", **mprl):
    """The policy with ``model``'s committed weights (those its nets have)."""
    config = _config(model, **mprl)
    policy = ModelPredictiveRLPolicy(config.policy, config.env, device=device)
    weights = mprl_networks_from_flax(checkpoints.load_flax_tree(model))
    own = policy.networks.state_dict()
    policy.networks.load_state_dict({k: v for k, v in weights.items()
                                     if k in own})
    return config, policy


def _states(config, policy, cases=64, steps=6):
    """States ``steps`` decisions into the first ``cases`` test cases under
    ``policy``: (robot [cases, 9], observable humans [cases, N, 5])."""
    env = CrowdSim(config.env, device=policy.device)
    ex = Explorer(env, policy, config.policy.gamma)
    carry = ex.initial_carry(config.env.sim.test_seed_offset, range(cases))
    with torch.no_grad():
        for _ in range(steps):
            carry = EvalCarry(*ex.eval_step(*carry))
    s = carry.states
    return s.robot, TT.observable(s.humans)


# ------------------------------------------------------------------ CPU
def test_value_on_the_cpu_is_networks_value_bit_for_bit():
    for mprl in ({}, dict(canonicalize=True)):
        config, policy = _policy("cpu", **mprl)
        robot, humans = _states(config, policy, cases=4, steps=2)
        acts = policy._all_actions(robot)
        _build.reset_launch_counts()
        with torch.no_grad():
            _, nr, nh = policy._expand(robot, humans, acts)
            for r, h in ((robot, humans), (nr, nh)):
                assert torch.equal(policy.value(r, h),
                                   policy.networks.value(r, h))
            policy.predict(TT.JointState(robot, humans))
        assert not any(_build.launch_counts().values())


def _views(policy, robot, humans):
    """The value calls of one ``predict`` at d=2: name -> (robot, humans)
    as the planner builds them."""
    w = policy.width
    acts, _, nr, nh = policy._clip_actions(robot, humans, w)
    _, nr2, nh2 = policy._expand(nr, nh, policy._all_actions(nr))
    _, _, leaf_r, leaf_h = policy._clip_actions(nr, nh, w)
    return {"root clip": policy._expand(robot, humans,
                                        policy._all_actions(robot))[1:],
            "nodes": (nr, nh), "inner clip": (nr2, nh2),
            "leaves": (leaf_r, leaf_h)}


@pytest.mark.parametrize("B", [1, 500])
def test_plan_finds_the_shared_humans_of_the_planners_views(B):
    config, policy = _policy("cpu")
    g = torch.Generator().manual_seed(B)
    robot = torch.randn(B, 9, generator=g)
    humans = torch.randn(B, 5, 5, generator=g)
    with torch.no_grad():
        views = _views(policy, robot, humans)
    got = {}
    for name, (r, h) in views.items():
        k = r.dim() - 1
        p = rv.plan(r.shape[:-1], r.stride()[:k], h.stride()[:k], 5)
        got[name] = (p.n, p.group_size, p.groups, p.tiles)
    assert got == {"root clip": (81 * B, 81, B, -(-81 * B // 128)),
                   "nodes": (2 * B, 1, 2 * B, -(-2 * B // 21)),
                   "inner clip": (162 * B, 81, 2 * B, -(-162 * B // 128)),
                   "leaves": (4 * B, 1, 4 * B, -(-4 * B // 21))}
    shared = sum(n for n, group, _, _ in got.values() if group > 1)
    assert shared == 243 * B  # the clip levels' forwards


PLANS = {
    # (lead, robot strides, humans strides, N) -> (sizes, robot strides,
    # humans strides, group, groups, forwards a tile, tiles, groups a tile
    # may touch)
    "children": (((500, 81), (729, 9), (25, 0), 5),
                 ((1, 1, 500, 81), (0, 0, 729, 9), (0, 0, 25, 0), 81, 500,
                  128, 317, 3)),
    "children of nodes": (((500, 2, 81), (1458, 729, 9), (50, 25, 0), 5),
                          ((1, 1, 1000, 81), (0, 0, 729, 9), (0, 0, 25, 0),
                           81, 1000, 128, 633, 3)),
    "gathered": (((500, 2, 2), (36, 18, 9), (100, 50, 25), 5),
                 ((1, 1, 1, 2000), (0, 0, 0, 9), (0, 0, 0, 25), 1, 2000, 21,
                  96, 21)),
    "ten humans": (((300,), (9,), (50,), 10),
                   ((1, 1, 1, 300), (0, 0, 0, 9), (0, 0, 0, 50), 1, 300, 9,
                    34, 9)),
    "a group over a tile": (((3, 700), (6300, 9), (25, 0), 5),
                            ((1, 1, 3, 700), (0, 0, 6300, 9), (0, 0, 25, 0),
                             700, 3, 128, 17, 2)),
    "shared along an outer dimension": (((4, 81), (729, 9), (0, 25), 5),
                                        ((1, 1, 4, 81), (0, 0, 729, 9),
                                         (0, 0, 0, 25), 1, 324, 21, 16, 21)),
    "every forward one scene": (((2, 3), (27, 9), (0, 0), 5),
                                ((1, 1, 1, 6), (0, 0, 0, 9), (0, 0, 0, 0),
                                 6, 1, 6, 1, 1)),
    "empty": (((0, 81), (729, 9), (25, 0), 5),
              ((1, 1, 0, 81), (0, 0, 729, 9), (0, 0, 25, 0), 1, 0, 1, 0, 1)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_merges_groups_and_tiles(case):
    args, want = PLANS[case]
    p = rv.plan(*args)
    assert (p.sizes, p.robot_strides, p.human_strides, p.group_size,
            p.groups, p.tile, p.tiles, p.max_groups) == want
    assert p.n == p.groups * p.group_size
    assert p.tile <= rv.TEAMS and p.tiles * p.tile >= p.n
    assert p.smem_bytes == rv.smem_bytes(args[3], p.max_groups) \
        <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("args,match", [
    (((4, 81), (729, 9), (25, 0), 0), "1 to 16"),
    (((4, 81), (729, 9), (25, 0), 17), "1 to 16"),
    (((2, 3, 2, 3, 2), (1, 3, 7, 11, 13), (5, 7, 1, 3, 2), 5),
     "does not merge")])
def test_plan_raises(args, match):
    with pytest.raises(ValueError, match=match):
        rv.plan(*args)


@pytest.mark.parametrize("model,mprl", [
    ("mprl_td", {}), ("mprl_td", dict(planning_width=4)),
    ("mprl_td", dict(share_graph_model=True)),
    ("mprl_td", dict(linear_state_predictor=True)),
    ("mprl_td", dict(canonicalize=True)), ("mp_unicycle_anneal", {})])
def test_the_config_check_takes_every_mprl_configuration(model, mprl):
    _, policy = _policy("cpu", model, **mprl)
    rv.check_networks(policy.networks)
    assert len(rv.weights(policy.networks)) == len(rv.SHAPES)


@pytest.mark.parametrize("key,value,match", [
    ("similarity_function", "gaussian", "similarity_function"),
    ("layerwise_graph", False, "layerwise_graph"),
    ("skip_connection", True, "skip_connection"),
    ("num_layer", 3, "num_layer"),
    ("wh_dims", (128, 32), "wh_dims"),
    ("value_network_dims", (150, 100, 100, 1), "value_network_dims")])
def test_the_config_check_raises_on_another_graph(key, value, match):
    config = _config()
    if key == "value_network_dims":
        policy_cfg = dataclasses.replace(config.policy, mprl=dataclasses
                                         .replace(config.policy.mprl,
                                                  **{key: value}))
    else:
        policy_cfg = dataclasses.replace(config.policy, gcn=dataclasses
                                         .replace(config.policy.gcn,
                                                  **{key: value}))
    policy = ModelPredictiveRLPolicy(policy_cfg, config.env, device="cpu")
    with pytest.raises(ValueError, match=match):
        rv.check_networks(policy.networks)


def test_the_wrapper_raises_in_grad_mode_and_on_cpu_tensors():
    _, policy = _policy("cpu")
    robot, humans = torch.zeros(3, 9), torch.zeros(3, 5, 5)
    policy.train()
    with pytest.raises(RuntimeError, match="no gradient"):
        rv.rgl_value(policy.networks, robot, humans)
    policy.eval()
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rv.rgl_value(policy.networks, robot, humans)
    assert not _build.launch_counts()["rgl_value"]


# ------------------------------------------- the source on the host's CPU
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/rgl_value.cu`` built by the host's C++ compiler against
    ``tests/cuda_stub/cuda_runtime.h``: (launch, prepare) of the library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's source on the host")
    src = (_build.CSRC / "rgl_value.cu").read_text()
    src, hits = re.subn(r"rgl_value_kernel<<<(.*?)>>>\(a\);",
                        r"stub_launch(rgl_value_kernel, \1, a);", src,
                        flags=re.S)
    assert hits == 1
    out = tmp_path_factory.mktemp("host_kernel")
    (out / "rgl_value_host.cpp").write_text(
        src + "\nnamespace { alignas(16) float4 smem[stub::kSmemFloat4]; }\n")
    lib = out / "librgl_value_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(ROOT / "tests" / "cuda_stub"), "-I",
                    str(_build.CSRC), "-o", str(lib),
                    str(out / "rgl_value_host.cpp")], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.rgl_value_launch.argtypes = [ctypes.c_void_p] * 6
    assert dll.rgl_value_prepare() == 0
    return dll


def _host_value(dll, networks, robot, humans):
    params = rv.weights(networks)
    k = robot.dim() - 1
    p = rv.plan(robot.shape[:-1], robot.stride()[:k], humans.stride()[:k],
                humans.shape[-2])
    out = torch.full(robot.shape[:-1], float("nan"))
    layout = (*p.sizes, *p.robot_strides, *p.human_strides, robot.stride(-1),
              humans.stride(-2), humans.stride(-1), p.n, p.group_size,
              p.tile, p.tiles, p.max_groups, humans.shape[-2])
    err = dll.rgl_value_launch(
        (ctypes.c_void_p * len(params))(*(t.data_ptr() for t in params)),
        robot.data_ptr(), humans.data_ptr(),
        (ctypes.c_int64 * len(layout))(*layout), out.data_ptr(), None)
    assert err == 0
    return out


@pytest.mark.parametrize("view", ["root clip", "nodes", "inner clip",
                                  "leaves"])
def test_the_kernel_source_computes_networks_value(host_kernel, view):
    """The planner's four views on states of the mprl_td test cases, B=3."""
    config, policy = _policy("cpu")
    robot, humans = _states(config, policy, cases=3, steps=3)
    with torch.no_grad():
        r, h = _views(policy, robot, humans)[view]
        got = _host_value(host_kernel, policy.networks, r, h)
        want = policy.networks.value(r, h)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("N,shared,lead", [
    (10, True, (2, 81)), (10, False, (40,)), (1, True, (3, 4)),
    (5, True, (1, 300)), (5, False, (200,)), (16, True, (2, 81))])
def test_the_kernel_source_on_other_shapes(host_kernel, N, shared, lead):
    """10, 1 and 16 humans (the bound), a group over a tile (300 children:
    three tiles of one group), gathered states over more tiles than
    blocks."""
    _, policy = _policy("cpu")
    g = torch.Generator().manual_seed(N + len(lead))
    robot = torch.randn(*lead, 9, generator=g)
    if shared:
        humans = torch.randn(*lead[:-1], N, 5, generator=g)[
            ..., None, :, :].expand(*lead, N, 5)
    else:
        humans = torch.randn(*lead, N, 5, generator=g)
    with torch.no_grad():
        got = _host_value(host_kernel, policy.networks, robot, humans)
        want = policy.networks.value(robot, humans)
    torch.testing.assert_close(got, want, **TOL)


# ------------------------------------------------------------------ card
def _held(policy, r, h):
    with torch.no_grad():
        got = policy.value(r, h)
        want = policy.networks.value(r, h)
    torch.testing.assert_close(got, want, **TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 500])
def test_cuda_kernel_equals_networks_value_on_the_planners_views(dev, B):
    config, policy = _policy(dev)
    robot, humans = _states(config, policy, cases=B)
    with torch.no_grad():
        views = _views(policy, robot, humans)
    assert views["root clip"][1].stride()[1] == 0   # shared humans
    for name, (r, h) in views.items():
        _held(policy, r, h)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5, 10])
def test_cuda_kernel_at_5_and_10_humans(dev, N):
    config, policy = _policy(dev)
    config = dataclasses.replace(config, env=dataclasses.replace(
        config.env, sim=dataclasses.replace(config.env.sim, human_num=N)))
    robot, humans = _states(config, policy, cases=200, steps=3)
    assert humans.shape[-2] == N
    with torch.no_grad():
        for r, h in _views(policy, robot, humans).values():
            _held(policy, r, h)


@pytest.mark.cuda
@pytest.mark.parametrize("model,mprl", [
    ("mprl_td", dict(canonicalize=True)),
    ("mprl_td", dict(share_graph_model=True)),
    ("mprl_td", dict(planning_width=4)), ("mp_unicycle_anneal", {})])
def test_cuda_kernel_on_the_other_configurations(dev, model, mprl):
    config, policy = _policy(dev, model, **mprl)
    robot, humans = _states(config, policy, cases=100, steps=3)
    with torch.no_grad():
        for r, h in _views(policy, robot, humans).values():
            _held(policy, r, h)


def _adam_step(policy, robot, humans):
    """One in-place Adam step of the value nets on a made-up target."""
    policy.train()
    opt = torch.optim.Adam(policy.networks.parameters(), lr=1e-2)
    loss = (policy.networks.value(robot, humans) - 1.0).square().mean()
    loss.backward()
    opt.step()
    policy.eval()


@pytest.mark.cuda
def test_cuda_kernel_reads_the_live_parameters(dev):
    """After an in-place Adam step the kernel computes the new values, in
    an eager call and in a captured graph replayed after the step."""
    config, policy = _policy(dev)
    robot, humans = _states(config, policy, cases=64, steps=3)
    with torch.no_grad():
        r, h = _views(policy, robot, humans)["inner clip"]
        r, h = r.clone(), h.clone()   # the graph's static inputs
    graph = captured.Graphed(lambda a, b: policy.value(a, b), r, h)
    assert graph.launches["rgl_value"] == 1
    before = _held(policy, r, h).clone()
    torch.testing.assert_close(graph(r, h), before, rtol=0, atol=0)
    _adam_step(policy, robot, humans)
    after = _held(policy, r, h)
    assert (after - before).abs().max() > 1e-3
    torch.testing.assert_close(graph(r, h), after, rtol=0, atol=0)


def _returns(policy, robot, humans):
    """The root clip's actions' one-step values v1 [S, 81], the clipped
    actions [S, w] and their planning returns [S, w]."""
    acts = policy._all_actions(robot)
    rew, nr, nh = policy._expand(robot, humans, acts)
    v1 = rew + policy._gamma_bar(robot)[..., None] * policy.value(nr, nh)
    idx = torch.sort(v1, dim=-1, descending=True,
                     stable=True).indices[..., :policy.width]
    _, rw, cr, ch = policy._clip_actions(robot, humans, policy.width)
    q = rw + policy._gamma_bar(robot)[..., None] * policy.v_planning(
        cr, ch, policy.depth)
    return v1, idx, q


@pytest.mark.cuda
def test_cuda_planner_chooses_as_the_eager_planner_away_from_ties(dev):
    """500 states of the mprl_td test cases: the planner with the kernel
    chooses the eager planner's action wherever the eager root clip's edge
    and its top two returns are clear of the 1e-5 relative band."""
    config, policy = _policy(dev)
    robot, humans = _states(config, policy, cases=500)
    _, eager = _policy(dev)
    eager.value = eager.networks.value
    js = TT.JointState(robot, humans)
    with torch.no_grad():
        got = policy.predict(js)
        want = eager.predict(js)
        v1, _, q = _returns(eager, robot, humans)
    w = policy.width
    top = v1.sort(dim=-1, descending=True).values
    band = lambda x: TIE * x.abs().clamp(min=1.0)  # noqa: E731
    clear = ((top[:, w - 1] - top[:, w]) > band(top[:, w - 1])) & (
        (q.max(-1).values - q.min(-1).values) > band(q.max(-1).values))
    assert clear.sum() > 400
    assert torch.equal(got[clear], want[clear])


@pytest.mark.cuda
def test_cuda_kernel_raises(dev):
    config, policy = _policy(dev)
    robot = torch.zeros(4, 9, device=dev)
    humans = torch.zeros(4, 5, 5, device=dev)
    with pytest.raises(TypeError, match="float32"):
        policy.value(robot.double(), humans.double())
    policy.train()
    with pytest.raises(RuntimeError, match="no gradient"):
        policy.value(robot, humans)
    policy.eval()
    cfg = dataclasses.replace(config.policy, gcn=dataclasses.replace(
        config.policy.gcn, similarity_function="gaussian"))
    other = ModelPredictiveRLPolicy(cfg, config.env, device=dev)
    with pytest.raises(ValueError, match="similarity_function"):
        other.value(robot, humans)
    with pytest.raises(ValueError, match="humans has shape"):
        policy.value(robot, humans[:2])


def _planner_forwards(config, width):
    """``benchmarks/counters/flops.py::planner_forwards`` of the mp_rgl
    configuration at ``width``: (value forwards, predictor forwards)."""
    from benchmarks.counters import flops
    bench = json.loads((ROOT / "benchmarks" / "configs" / "mp_rgl.json")
                       .read_text())
    bench["policy"]["mprl"]["planning_width"] = width
    return flops.planner_forwards(bench)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 4])
def test_cuda_predict_counts_its_forwards_and_launches(dev, width):
    """One ``predict`` of B states: four launches (the root clip, the
    nodes' own values, the inner clip, the leaves), the forwards of the
    FLOP count, and the clip levels' forwards shared."""
    config, policy = _policy(dev, planning_width=width)
    B = 100
    robot, humans = _states(config, policy, cases=B, steps=1)
    profiling.reset()
    profiling.enable()
    _build.reset_launch_counts()
    try:
        with torch.no_grad():
            policy.predict(TT.JointState(robot, humans))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    values, _ = _planner_forwards(config, width)
    assert _build.launch_counts() == {
        **{k: 0 for k in _build.launch_counts()}, "rgl_value": 4}
    assert counters["plan.value_kernel_forwards"] == values * B
    assert counters["plan.value_shared_forwards"] == (81 + 81 * width) * B
