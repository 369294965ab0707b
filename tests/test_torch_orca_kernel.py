"""ORCA's velocity kernel (``ops/orca.py``, ``csrc/orca_velocity.cu``).

On the CPU: ``envs/orca.py::orca_velocity`` runs the plain version and
launches nothing; the wrapper's checks of shapes, types, M and the device
raise before any launch; its layout reads expanded neighbour tables through
their strides; ``utils/profiling.py`` reads a device counter into a
snapshot and zeroes it at a reset.

On the card (marker ``cuda``): the kernel against the plain version
(``orca_velocity_plain``) on the card, ``torch.equal``: the dense env's
shapes (B=500 with 5 humans, the robot visible at n=6, B=16), the crowd's
kNN shapes at n=10,240 and K=10 at the reference's density, the
partitioned path's gathered shapes, M=1 and M=64, and crafted states
(colliding pairs, parallel and anti-parallel lines, linearProgram2
infeasible so that linearProgram3 runs, inactive agents, an agent with no
valid neighbour); the counter ``orca.lp3_agents``;
the raises for M > 64 and a wrong type; and 500 evaluation cases through
``Explorer.rollout`` with the kernel and with the plain version, equal.
Card tests import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_orca_kernel.py --noconftest -m cuda
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.envs import mega_crowd
from relationalgraphlearning_tpu_torch.envs import orca as torca
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import orca as tok
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training.explorer import Explorer
from relationalgraphlearning_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PARAMS = torca.ORCAParams()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _agents(n, M, spread, seed=0, device="cpu"):
    """n agents each against M neighbours, in the plain version's argument
    order; a small `spread` makes colliding pairs and infeasible LPs."""
    rng = np.random.RandomState(seed)
    f = [rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 2)),
         np.full(n, 0.3), rng.uniform(-1, 1, (n, 2)), np.ones(n),
         rng.uniform(-spread, spread, (n, M, 2)),
         rng.uniform(-1, 1, (n, M, 2)), np.full((n, M), 0.3)]
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in f]
    return out + [torch.tensor(rng.rand(n, M) > 0.15, device=device)]


def _dense(B, n, seed=0, device="cpu"):
    """``centralized_orca_step``'s operands: every agent of an env against
    the env's n (expanded, not copied) with itself masked."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    pos = t(rng.uniform(-4, 4, (B, n, 2)))
    vel = t(rng.uniform(-1, 1, (B, n, 2)))
    rad, vmax = t(np.full((B, n), 0.3)), t(np.ones((B, n)))
    pref = t(rng.uniform(-1, 1, (B, n, 2)))
    eye = torch.eye(n, dtype=torch.bool, device=device)
    valid = torch.ones(B, 1, n, dtype=torch.bool, device=device) & ~eye
    return (pos, vel, rad, pref, vmax,
            pos[..., None, :, :].expand(B, n, n, 2),
            vel[..., None, :, :].expand(B, n, n, 2),
            rad[..., None, :].expand(B, n, n), valid)


def _crowd(n=10240, K=10, seed=0, device="cpu"):
    """``centralized_orca_step_knn``'s operands on a crowd at the
    reference's density, every 97th agent inactive."""
    g = torch.Generator().manual_seed(seed)
    pos = mega_crowd.initial_crowd(n, seed=seed, device="cpu")
    vel = torch.rand(n, 2, generator=g) - 0.5
    pref = torch.rand(n, 2, generator=g) * 2 - 1
    rad, vmax = torch.full((n,), 0.3), torch.ones(n)
    act = torch.ones(n, dtype=torch.bool)
    act[::97] = False
    pos, vel, pref, rad, vmax, act = (t.to(device) for t in
                                      (pos, vel, pref, rad, vmax, act))
    cols = knn_graph_auto(pos, K, valid=act)
    me = torch.arange(n, device=device)[:, None]
    return (pos, vel, rad, pref, vmax, pos[cols], vel[cols], rad[cols],
            act[cols] & (cols != me))


def _crafted(device="cpu"):
    """One agent at the origin per row, against 4 neighbour slots: head-on
    colliding pairs from both sides (anti-parallel lines), the same
    neighbour three times (parallel lines), boxed in on four sides (LP2
    infeasible), no valid neighbour, neighbours out of range."""
    z = [0.0, 0.0]
    rows = [  # (v_i, pref, neighbour positions, velocities, valid)
        (z, [1.0, 0.0], [[0.5, 0.0], [-0.5, 0.0], z, z],
         [z, z, z, z], [1, 1, 0, 0]),
        (z, [1.0, 0.0], [[2.0, 0.0], [-2.0, 0.0], z, z],
         [[-1.0, 0.0], [1.0, 0.0], z, z], [1, 1, 0, 0]),
        ([0.5, 0.1], [1.0, 0.0], [[0.5, 0.0]] * 3 + [[0.0, 0.5]],
         [z] * 4, [1, 1, 1, 1]),
        (z, [1.0, 0.0], [[0.4, 0.0], [-0.4, 0.0], [0.0, 0.4], [0.0, -0.4]],
         [z] * 4, [1, 1, 1, 1]),
        (z, [1.0, 0.5], [[0.4, 0.0], [-0.4, 0.0], z, z], [z] * 4,
         [0, 0, 0, 0]),
        (z, [2.0, 0.5], [[20.0, 0.0], [0.0, -40.0], z, z], [z] * 4,
         [1, 1, 0, 0]),
    ]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    n = len(rows)
    return (t([z] * n), t([r[0] for r in rows]), t([0.3] * n),
            t([r[1] for r in rows]), t([1.0] * n), t([r[2] for r in rows]),
            t([r[3] for r in rows]), t([[0.3] * 4] * n),
            torch.tensor([r[4] for r in rows], dtype=torch.bool,
                         device=device))


def _lp3_agents(args):
    """Agents whose linearProgram2 fails, by the plain version."""
    p_i, v_i, r_i, pref, vmax, p_j, v_j, r_j, valid = args
    pts, dirs, lv = torca.orca_lines(p_i, v_i, r_i, p_j, v_j, r_j, valid,
                                     PARAMS)
    _, fail = torca._linear_program2(pts, dirs, lv, vmax, pref, False)
    return int((fail < pts.shape[-2]).sum())


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("case", ["agents", "dense", "crowd", "crafted",
                                  "float64"])
def test_orca_velocity_runs_the_plain_version_on_the_cpu(case):
    args = {"agents": lambda: _agents(64, 10, 1.5),
            "dense": lambda: _dense(8, 5),
            "crowd": lambda: _crowd(512),
            "crafted": _crafted,
            "float64": lambda: [t.double() if t.is_floating_point() else t
                                for t in _agents(32, 6, 2.0)]}[case]()
    tbuild.reset_launch_counts()
    got = torca.orca_velocity(*args, PARAMS)
    assert torch.equal(got, torca.orca_velocity_plain(*args, PARAMS))
    assert tbuild.launch_counts()["orca_velocity"] == 0


def _bad(change, M=3):
    args = list(_agents(4, M, 2.0))
    change(args)
    return args


def _keep(args):
    pass


@pytest.mark.parametrize("change,M,error,match", [
    (lambda a: a.__setitem__(0, a[0].double()), 3, TypeError, "p_i is"),
    (lambda a: a.__setitem__(8, a[8].float()), 3, TypeError, "valid is"),
    (lambda a: a.__setitem__(4, a[4].half()), 3, TypeError, "max_speed is"),
    (_keep, 65, ValueError, "65 neighbours"),
    (_keep, 0, ValueError, "0 neighbours"),
    (lambda a: a.__setitem__(1, torch.zeros(4, 3)), 3, ValueError,
     "last dimension is not 2"),
    (lambda a: a.__setitem__(7, torch.zeros(5, 3)), 3, ValueError,
     "do not broadcast"),
    (lambda a: a.__setitem__(7, torch.zeros(4, 2)), 3, ValueError,
     "do not broadcast"),
    (_keep, 3, ValueError, "not on a CUDA device"),
])
def test_the_kernel_wrapper_raises_before_any_launch(change, M, error,
                                                     match):
    tbuild.reset_launch_counts()
    with pytest.raises(error, match=match):
        tok.orca_velocity(*_bad(change, M), PARAMS)
    assert tbuild.launch_counts()["orca_velocity"] == 0


def test_the_layout_reads_expanded_tables_through_their_strides():
    args = _dense(500, 5)
    ops, lead, M, sizes, strides = tok.operands(*args)
    assert (lead, M) == ((500, 5), 5)
    assert sizes == [1, 1, 500, 5]
    p_j = ops["p_j"]
    assert p_j.data_ptr() == args[0].data_ptr()       # not copied
    assert strides[tok.OPERANDS.index("p_i")] == [0, 0, 10, 2, 0, 1]
    assert strides[tok.OPERANDS.index("p_j")] == [0, 0, 10, 0, 2, 1]
    assert strides[tok.OPERANDS.index("valid")] == [0, 0, 25, 5, 1, 0]
    # contiguous operands merge into one leading dimension
    _, lead, _, sizes, strides = tok.operands(
        *(t.contiguous() for t in args))
    assert lead == (500, 5) and sizes == [1, 1, 1, 2500]
    assert strides[tok.OPERANDS.index("p_j")] == [0, 0, 0, 10, 2, 1]
    # strided rows (the robot policy's slices of a state) and broadcasting
    rob = torch.zeros(3, 9)
    hum = torch.zeros(3, 5, 5)
    _, lead, M, sizes, strides = tok.operands(
        rob[:, 0:2], rob[:, 2:4], rob[:, 4], rob[:, 5:7], rob[:, 7],
        hum[..., 0:2], hum[..., 2:4], hum[..., 4],
        torch.ones(1, dtype=torch.bool))
    assert (lead, M, sizes) == ((3,), 5, [1, 1, 1, 3])
    assert strides[tok.OPERANDS.index("r_i")] == [0, 0, 0, 9, 0, 0]
    assert strides[tok.OPERANDS.index("v_j")] == [0, 0, 0, 25, 5, 1]
    assert strides[tok.OPERANDS.index("valid")] == [0, 0, 0, 0, 0, 0]


def test_the_layout_imports_nothing_more():
    """``torch.broadcast_shapes`` imports sympy at its first call, seconds
    of every evaluation cell's set-up: the wrapper broadcasts by itself."""
    probe = ("import sys, torch\n"
             "from relationalgraphlearning_tpu_torch.ops import orca\n"
             "orca.operands(*[torch.zeros(3, 2)] * 2, torch.zeros(3),\n"
             "              torch.zeros(3, 2), torch.zeros(1),\n"
             "              *[torch.zeros(3, 4, 2)] * 2, torch.zeros(4),\n"
             "              torch.ones(3, 4, dtype=torch.bool))\n"
             "print('sympy' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def test_the_kernel_compares_with_the_plain_versions_eps():
    assert tok.EPS == torca._EPS


def test_a_device_counter_is_read_by_snapshot_and_zeroed_by_reset(
        monkeypatch):
    monkeypatch.setattr(profiling, "_device_counters", [])
    t = torch.tensor([5, 7])
    profiling.device_counter("k.a", t[0])
    profiling.device_counter("k.b", t[1])
    profiling.enable()
    try:
        profiling.count("k.a", 2)
        assert profiling.snapshot()["counters"] == {"k.a": 7, "k.b": 7}
        profiling.reset()
        assert t.tolist() == [0, 0]
        assert profiling.snapshot()["counters"] == {"k.a": 0, "k.b": 0}
    finally:
        profiling.disable()
        profiling.reset()


# ------------------------------------------------------------ on the card
def _equal_on_card(args, what):
    tbuild.reset_launch_counts()
    got = torca.orca_velocity(*args, PARAMS)
    want = torca.orca_velocity_plain(*args, PARAMS)
    torch.cuda.synchronize()
    assert tbuild.launch_counts()["orca_velocity"] == 1, what
    assert got.shape == want.shape and got.dtype == torch.float32, what
    bad = (got != want).any(-1)
    assert torch.equal(got, want), (
        f"{what}: {int(bad.sum())} agents differ, max |diff| "
        f"{float((got - want).abs().max()):.3g}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(500, 5), (500, 6), (16, 6), (16, 5)])
def test_cuda_kernel_equals_plain_on_the_dense_env_shapes(dev, B, n):
    for seed in range(3):
        _equal_on_card(_dense(B, n, seed, dev), f"B={B} n={n} seed={seed}")


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_on_the_envs_own_states(dev):
    """500 test cases' humans (and the robot visible) from the env's own
    draw, 20 steps in, through ``centralized_orca_step``."""
    config = load_config_module(str(ROOT / "results" / "mprl_td" /
                                    "config.py"))
    env = CrowdSim(config.env, device=dev)
    state, _ = env.reset(range(500), config.env.sim.test_seed_offset)
    h, r = state.humans, state.robot[:, None]
    pos = torch.cat([T.position(h), T.position(r)], 1)
    vel = torch.cat([T.velocity(h), T.velocity(r)], 1)
    rad = torch.cat([h[..., T.RADIUS], r[..., T.RADIUS]], 1)
    vmax = torch.cat([h[..., T.VPREF], r[..., T.VPREF]], 1)
    to = torch.cat([h[..., T.GX:T.GY + 1], r[..., T.GX:T.GY + 1]], 1) - pos
    pref = to / torch.clamp(torch.linalg.norm(to, dim=-1, keepdim=True),
                            min=1e-9) * vmax[..., None]
    for n in (5, 6):                  # the robot invisible, then visible
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        valid = torch.ones(500, 1, n, dtype=torch.bool, device=dev) & ~eye
        p, v = pos[:, :n].clone(), vel[:, :n].clone()
        for step in range(20):
            args = (p, v, rad[:, :n], pref[:, :n], vmax[:, :n],
                    p[:, None].expand(500, n, n, 2),
                    v[:, None].expand(500, n, n, 2),
                    rad[:, None, :n].expand(500, n, n), valid)
            v = _equal_on_card(args, f"n={n} step {step}")
            p = p + 0.25 * v


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_on_the_crowd(dev):
    """n=10,240, K=10 at the reference's density, and 8 steps rolled on."""
    args = _crowd(device=dev)
    _equal_on_card(args, "crowd")
    pos, vel, rad, pref, vmax = args[:5]
    active = torch.ones(pos.shape[0], dtype=torch.bool, device=dev)
    active[::97] = False
    cols = knn_graph_auto(pos, 10, valid=active)
    me = torch.arange(pos.shape[0], device=dev)[:, None]
    for step in range(8):
        new_v = _equal_on_card(
            (pos, vel, rad, pref, vmax, pos[cols], vel[cols], rad[cols],
             active[cols] & (cols != me)), f"crowd step {step}")
        vel = torch.where(active[:, None], new_v, 0.0)
        pos = pos + 0.25 * vel


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_on_the_partitioned_shapes(dev):
    """A rank's slab against its extended table (slab and halo), K_orca of
    a wider neighbour table, gathered as ``partitioned_build._orca_step``
    gathers it."""
    g = torch.Generator().manual_seed(4)
    n_local, n_ext, K, K_orca = 2560, 4096, 16, 10
    side = 100.0
    pos_ext = ((torch.rand(n_ext, 2, generator=g) * 2 - 1) * side).to(dev)
    vel_ext = (torch.rand(n_ext, 2, generator=g) - 0.5).to(dev)
    rad_ext = torch.full((n_ext,), 0.3, device=dev)
    pos, vel = pos_ext[:n_local], vel_ext[:n_local]
    eidx = knn_graph_auto(pos_ext, K)[:n_local]
    colvalid = torch.rand(n_local, K, generator=g).to(dev) > 0.1
    idx = eidx[:, :K_orca]
    pref = (torch.rand(n_local, 2, generator=g) * 2 - 1).to(dev)
    _equal_on_card((pos, vel, rad_ext[:n_local], pref,
                    torch.ones(n_local, device=dev), pos_ext[idx],
                    vel_ext[idx], rad_ext[idx], colvalid[:, :K_orca]),
                   "partitioned")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16, 17, 32, 33, 64])
def test_cuda_kernel_equals_plain_at_every_width(dev, M):
    for spread in (4.0, 2.0, 1.0, 0.5):
        args = _agents(512 if M <= 16 else 128, M, spread, seed=M,
                       device=dev)
        _equal_on_card(args, f"M={M} spread={spread}")


@pytest.mark.cuda
def test_cuda_kernel_on_crafted_states_and_its_counters(dev):
    """The crafted states equal the plain version; ``orca.lp3_agents``
    counts the agents whose linearProgram2 failed, over two launches; a
    reset zeroes it."""
    args = _crafted(dev)
    lp3 = _lp3_agents(args)
    assert lp3 >= 2               # head-on and boxed in
    profiling.reset()
    profiling.enable()
    try:
        _equal_on_card(args, "crafted")
        _equal_on_card(_agents(1000, 10, 1.0, device=dev), "pile-up")
        counters = profiling.snapshot()["counters"]
        profiling.reset()
        after = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    pile = _lp3_agents(_agents(1000, 10, 1.0, device=dev))
    assert pile > 100
    assert counters["orca.lp3_agents"] == lp3 + pile
    assert after["orca.lp3_agents"] == 0


@pytest.mark.cuda
def test_cuda_kernel_keeps_inactive_agents_and_masks_as_the_step_does(dev):
    """``centralized_orca_step(_knn)`` on the card: inactive agents at zero,
    the whole step equal to the same step with the plain version."""
    pos, vel, rad, pref, vmax = (t.to(dev) for t in _dense(64, 6, 3)[:5])
    active = torch.rand(64, 6, generator=torch.Generator().manual_seed(1)
                        ).to(dev) > 0.3
    got = torca.centralized_orca_step(pos, vel, rad, pref, vmax, active,
                                      PARAMS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torca, "orca_velocity", torca.orca_velocity_plain)
        want = torca.centralized_orca_step(pos, vel, rad, pref, vmax, active,
                                           PARAMS)
    assert torch.equal(got, want)
    assert (got[~active] == 0).all()


@pytest.mark.cuda
def test_cuda_kernel_wrapper_raises(dev):
    args = _agents(8, 65, 2.0, device=dev)
    with pytest.raises(ValueError, match="65 neighbours"):
        torca.orca_velocity(*args, PARAMS)
    args = [t.double() if t.is_floating_point() else t
            for t in _agents(8, 10, 2.0, device=dev)]
    with pytest.raises(TypeError, match="float32"):
        torca.orca_velocity(*args, PARAMS)
    args = _agents(8, 10, 2.0, device=dev)
    args[3] = args[3].cpu()
    with pytest.raises(ValueError, match="not on a CUDA device"):
        torca.orca_velocity(*args, PARAMS)


@pytest.mark.cuda
def test_cuda_500_cases_equal_with_the_kernel_and_the_plain_version(dev):
    """MP-RGL's 500 test cases through ``Explorer.rollout`` (graphed), the
    humans' ORCA by the kernel and by the plain version: every case's
    outcome, steps and final state equal."""
    def rollout():
        config = load_config_module(str(ROOT / "results" / "mprl_td" /
                                        "config.py"))
        env = CrowdSim(config.env, device=dev)
        policy = ModelPredictiveRLPolicy(config.policy, config.env,
                                         device=dev)
        policy.load_flax(checkpoints.load_flax_tree("mprl_td"))
        ex = Explorer(env, policy, config.policy.gamma)
        with torch.no_grad():
            return ex.rollout(config.env.sim.test_seed_offset, range(500))

    tbuild.reset_launch_counts()
    got = rollout()
    assert tbuild.launch_counts()["orca_velocity"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torca, "orca_velocity", torca.orca_velocity_plain)
        want = rollout()
    assert (got.case_outcome == 1).sum() >= 450
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
