"""The port's headline benchmark (``tools/bench.py``) on the CPU, against
the reference's ``bench.py`` and the JAX package.

- The linear robot's auto-resetting collection, the collector the tool
  times, against the JAX package's ``Explorer.collect`` at B=8 over 16
  steps, from the same case keys: dones exactly; rewards, actions and the
  robot's states within 1e-5 (float32 on both sides; the robot's motion is
  the linear policy's alone, and the humans' ORCA reaches the reward only
  through the distances, 2e-7 apart here).
- ``main`` at a tiny size prints the reference's one line with exactly its
  keys (read from ``bench.py``'s source), ``extra`` included, after the
  eager line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_reference import key_tree, printed_dicts
from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu.configs.base import (
    EnvConfig as JEnvConfig, PolicyConfig as JPolicyConfig)
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.policies.factory import (
    make_policy as jmake)
from relationalgraphlearning_tpu.training.explorer import Explorer as JExplorer
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.tools import bench
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

B, STEPS = 8, 16
TINY_EXTRA = "--edges_n 512 --inner 2 --batch 2 --steps 2 --trials 1"


def test_linear_collection_matches_jax():
    jcfg = JEnvConfig(human_policy="orca")
    jex = JExplorer(JCrowdSim(jcfg), jmake("linear", JPolicyConfig(), jcfg),
                    0.9)
    jcarry = jex.init_carry(B, 0, jax.random.PRNGKey(0))
    jcarry, jtraj = jax.jit(lambda c: jex.collect(
        None, c, STEPS, jnp.asarray(0.0), 0))(jcarry)
    cfg = EnvConfig(human_policy="orca")
    ex = Explorer(CrowdSim(cfg, device="cpu"),
                  make_policy("linear", PolicyConfig(), cfg, device="cpu"),
                  0.9)
    carry, traj = ex.collect(ex.init_carry(B, 0), STEPS, 0)
    np.testing.assert_array_equal(traj.terminal.numpy(),
                                  np.asarray(jtraj.terminal))
    assert traj.terminal.any()  # an episode ended inside the window
    for got, want in ((traj.reward, jtraj.reward), (traj.robot, jtraj.robot),
                      (traj.next_robot, jtraj.next_robot),
                      (traj.action, jtraj.action),
                      (carry.robot, jcarry.env_states.robot)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(carry.case_counter.numpy(),
                                  np.asarray(jcarry.case_counter))


def test_linear_action_is_the_references():
    robot = torch.tensor([[0.0, -4.0, 0.0, 0.0, 0.3, 0.0, 4.0, 1.0, 0.0],
                          [1.0, 1.0, 0.0, 0.0, 0.3, 1.0, 1.0, 1.0, 0.0]])
    act = bench.linear_action(robot)
    torch.testing.assert_close(act, torch.tensor([[0.0, 1.0], [0.0, 0.0]]))


def test_main_prints_the_references_line(capsys):
    out = bench.main(["--device", "cpu", "--batch", "8", "--horizon", "4",
                      "--repeats", "2", "--trials", "2", "--seconds", "0.3",
                      "--extra_args", TINY_EXTRA])
    lines = capsys.readouterr().out.strip().splitlines()
    (want, metric), = printed_dicts("bench.py")
    line = json.loads(lines[-1])
    assert key_tree(line) == want
    assert line["metric"] == metric == "env-steps/s"
    assert line == out["line"]
    assert line["device"] == "cpu" and line["batch"] == 8
    assert json.loads(lines[-2])["metric"] == "env-steps/s (eager)"
    assert line["value"] > 0 and line["baseline_cpu_python_loop"] > 0
    assert line["extra"]["block_coverage"] == 1.0
    # no kernel runs on the collector's path, and no capture on the CPU
    assert not any(out["collector"]["launches"].values())
    assert out["collector"]["graphed"] is False


def test_the_card_is_required_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--batch", "8"])
