"""The port's host-side utilities against the JAX package's:

- ``utils/render.rollout_trajectory`` of an ``mprl_td`` test case (the
  committed weights) against the reference's: every recorded state at
  atol 1e-4 (``test_torch_crowd_sim.py``'s bound for ORCA's LP over an
  episode), outcome and steps equal, the robot row of the attention at
  atol 1e-5, the return at rel 1e-5;
- ``render_traj`` writes a PNG and ``render_video`` a GIF; an mp4 without
  ffmpeg raises before drawing;
- ``utils/plot.load_jsonl`` / ``load_log`` against the reference's on the
  same files, and ``main`` writes the curves;
- ``utils/profiling.trace`` writes a Chrome trace holding an ``annotate``d
  region;
- ``cli.test --visualize --test_case k --traj --video_file`` rolls that
  case and writes both files (the reference's ``cli/test.py:154-167``).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import configs, policies
from relationalgraphlearning_tpu.envs import CrowdSim as JCrowdSim
from relationalgraphlearning_tpu.utils import plot as jplot
from relationalgraphlearning_tpu.utils import render as jrender
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.utils import plot, profiling, render

CASE = 2


@pytest.fixture(scope="module")
def trajectories():
    cfg_j, cfg_t = configs("mprl_td")
    pol_j, params, pol_t = policies("mprl_td")
    offset = cfg_t.env.sim.test_seed_offset
    want = jrender.rollout_trajectory(JCrowdSim(cfg_j.env), pol_j, params,
                                      offset, CASE)
    got = render.rollout_trajectory(CrowdSim(cfg_t.env, device="cpu"),
                                    pol_t, offset, CASE)
    return got, want


def test_rollout_trajectory_matches_the_reference(trajectories):
    got, want = trajectories
    assert got.outcome == want.outcome and got.steps == want.steps
    assert got.outcome_name == want.outcome_name
    assert got.robot.shape == want.robot.shape
    np.testing.assert_allclose(got.robot, want.robot, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.humans, want.humans, atol=1e-4, rtol=0)
    assert got.attention is not None and want.attention is not None
    np.testing.assert_allclose(got.attention, want.attention, atol=1e-5,
                               rtol=0)
    assert got.cumulative_reward == pytest.approx(want.cumulative_reward,
                                                  rel=1e-5)
    assert (got.time_step, got.robot_radius) == (want.time_step,
                                                 want.robot_radius)


def test_exploration_draws_from_the_given_generator():
    _, cfg_t = configs("mprl_td")
    _, _, pol_t = policies("mprl_td")
    env = CrowdSim(cfg_t.env, device="cpu")
    offset = cfg_t.env.sim.test_seed_offset

    def roll(seed):
        return render.rollout_trajectory(
            env, pol_t, offset, CASE, epsilon=0.5,
            generator=torch.Generator().manual_seed(seed))

    a, b = roll(1), roll(1)
    np.testing.assert_array_equal(a.robot, b.robot)
    with pytest.raises(ValueError, match="generator or draws"):
        render.rollout_trajectory(env, pol_t, offset, CASE, epsilon=0.5)


def _short(traj, frames=6):
    return render.EpisodeTrajectory(
        robot=traj.robot[:frames], humans=traj.humans[:frames],
        attention=traj.attention[:frames - 1], outcome=traj.outcome,
        steps=frames - 1, time_step=traj.time_step,
        cumulative_reward=traj.cumulative_reward,
        robot_radius=traj.robot_radius)


def test_render_writes_a_png_and_a_gif(trajectories, tmp_path):
    got, _ = trajectories
    png, gif = tmp_path / "traj.png", tmp_path / "case.gif"
    render.render_traj(got, str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    render.render_video(_short(got), str(gif))
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a")


def test_mp4_without_ffmpeg_raises(trajectories, tmp_path, monkeypatch):
    got, _ = trajectories
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        render.render_video(_short(got), str(tmp_path / "case.mp4"))
    assert not (tmp_path / "case.mp4").exists()


def test_plot_loaders_match_the_reference(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rows = [{"step": 0, "time": 1.0, "il/value_loss": 0.5},
            {"step": 20, "time": 2.0, "val/success_rate": 0.4,
             "val/return": 0.1},
            {"step": 40, "time": 3.0, "val/success_rate": 0.6,
             "rl/value_loss": 0.02}]
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    (run / "output.log").write_text(
        "2026-01-01 00:00:00, INFO: RL ep 20 it 1 eps 0.40 | val success "
        "0.40 coll 0.10 nav 12.00s ret 0.100 | vloss 0.1\n"
        "noise\n"
        "2026-01-01 00:00:01, INFO: RL ep 40 it 2 eps 0.30 | val success "
        "0.60 coll 0.05 nav 11.50s ret 0.200 | vloss 0.1\n")
    for name in ("metrics.jsonl",):
        assert dict(plot.load_jsonl(str(run / name))) == dict(
            jplot.load_jsonl(str(run / name)))
    assert dict(plot.load_log(str(run / "output.log"))) == dict(
        jplot.load_log(str(run / "output.log")))
    out = plot.main([str(run)])
    assert (run / "curves.png").read_bytes()[:4] == b"\x89PNG" and out


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("rgl_region"):
            torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE)
                       .read_text())
    assert any(e.get("name") == "rgl_region" for e in trace["traceEvents"])
    with profiling.trace(None) as nothing:   # off: a no-op
        assert nothing is None


def test_cli_visualize_writes_the_case(trajectories, tmp_path, capsys):
    from relationalgraphlearning_tpu_torch.cli import test as cli
    got, _ = trajectories
    png, gif = tmp_path / "case.png", tmp_path / "case.gif"
    traj = cli.main(["--model_dir", "results/mprl_td", "--visualize",
                     "--test_case", str(CASE), "--traj", str(png),
                     "--video_file", str(gif), "--device", "cpu"])
    np.testing.assert_array_equal(traj.robot, got.robot)
    assert png.stat().st_size > 0 and gif.stat().st_size > 0
    assert f"case {CASE}: outcome={got.outcome_name}" in \
        capsys.readouterr().err
