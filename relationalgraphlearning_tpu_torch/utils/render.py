"""Episode rendering (port of ``relationalgraphlearning_tpu/utils/render.py``):
host-side matplotlib over a recorded trajectory.

``rollout_trajectory`` plays one seeded case to its end, recording every
state (and the robot row of the value graph's attention when the policy
has ``attention``); ``render_traj`` draws it as a static matplotlib plot
with the agents' positions every ``stride`` steps, ``render_video`` as an
animation whose frames Pillow draws (a GIF; an mp4 through ffmpeg), so a
video needs no matplotlib. The env stays render-free.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

_OUTCOME_NAMES = {0: "nothing", 1: "reach_goal", 2: "collision", 3: "timeout"}
GAMMA = 0.9  # the reference's return of a rendered episode


@dataclasses.dataclass
class EpisodeTrajectory:
    robot: np.ndarray  # [T+1, 9]
    humans: np.ndarray  # [T+1, N, 9]
    attention: Optional[np.ndarray]  # [T, N+1] robot-row attention or None
    outcome: int
    steps: int
    time_step: float
    cumulative_reward: float
    robot_radius: float

    @property
    def outcome_name(self):
        return _OUTCOME_NAMES[self.outcome]

    @property
    def nav_time(self):
        return self.steps * self.time_step


@torch.no_grad()
def rollout_trajectory(env: CrowdSim, policy, phase_offset: int,
                       case_idx: int, epsilon: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       base_seed: int = 0) -> EpisodeTrajectory:
    """Run one seeded case to its end (or the step limit), recording every
    state, and the robot row of the attention when the policy has
    ``attention``. Exploration at ``epsilon`` > 0 draws from
    ``generator``. The policy acts as ``Explorer`` makes it act (a
    lookahead policy reads the env's crowd step)."""
    state, _ = env.reset([case_idx], phase_offset, base_seed)
    expl = Explorer(env, policy, GAMMA, base_seed)
    robots = [state.robot[0].cpu().numpy()]
    humans = [state.humans[0].cpu().numpy()]
    attn = []
    reward_sum = 0.0
    attention = getattr(policy, "attention", None)
    t = 0
    while not bool(state.done[0]) and t < env.cfg.max_steps:
        if attention is not None:
            A = attention(state.robot, T.observable(state.humans))
            attn.append(A[0, 0].cpu().numpy())  # robot row over the nodes
        action = expl._act(state, epsilon, generator)
        out = expl._step(state, action)
        gamma_t = GAMMA ** (t * env.cfg.time_step
                            * float(state.robot[0, T.VPREF]))
        reward_sum += gamma_t * float(out.reward[0])
        state = out.state
        robots.append(state.robot[0].cpu().numpy())
        humans.append(state.humans[0].cpu().numpy())
        t += 1
    return EpisodeTrajectory(
        robot=np.stack(robots), humans=np.stack(humans),
        attention=np.stack(attn) if attn else None,
        outcome=int(state.outcome[0]), steps=int(state.step[0]),
        time_step=env.cfg.time_step, cumulative_reward=reward_sum,
        robot_radius=env.cfg.robot_radius)


def _setup_ax(ax, lim=5.0):
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_aspect("equal")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_traj(traj: EpisodeTrajectory, path: str, stride: int = 16):
    """Static plot with positions every ``stride`` steps (the reference's
    render('traj'), positions every 4 s) and the attention on each human
    when recorded."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    _setup_ax(ax)
    Tn, N = traj.humans.shape[0], traj.humans.shape[1]
    cmap = plt.colormaps["tab10"]
    ax.plot(traj.robot[:, 0], traj.robot[:, 1], "-", color="gold", lw=2,
            label="robot")
    for i in range(N):
        ax.plot(traj.humans[:, i, 0], traj.humans[:, i, 1], "--", lw=1,
                color=cmap(i))
    for t in range(0, Tn, stride):
        ax.add_artist(plt.Circle(traj.robot[t, :2], traj.robot_radius,
                                 fill=False, color="gold"))
        ax.text(traj.robot[t, 0] - 0.1, traj.robot[t, 1] - 0.25,
                f"{t * traj.time_step:.0f}", fontsize=8)
        for i in range(N):
            ax.add_artist(plt.Circle(traj.humans[t, i, :2],
                                     traj.humans[t, i, T.RADIUS],
                                     fill=False, color=cmap(i)))
            if traj.attention is not None and t < len(traj.attention):
                ax.text(traj.humans[t, i, 0] + 0.15,
                        traj.humans[t, i, 1] + 0.15,
                        f"{traj.attention[t, i + 1]:.2f}", fontsize=6,
                        color=cmap(i))
    ax.plot(traj.robot[0, T.GX], traj.robot[0, T.GY], "r*", markersize=14,
            label="goal")
    ax.legend(loc="upper left")
    ax.set_title(f"{traj.outcome_name}, nav time {traj.nav_time:.1f}s")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


_PX = 560          # a video frame's side in pixels: the arena's 10 m
_TAB10 = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
          (188, 189, 34), (23, 190, 207)]


def _frames(traj: EpisodeTrajectory, lim: float = 5.0) -> list:
    """The episode's frames as Pillow images (the robot filled gold, each
    human a ring of its colour, the goal a red cross, the time and outcome
    on top)."""
    from PIL import Image, ImageDraw

    scale = _PX / (2 * lim)

    def px(x, y):
        return (x + lim) * scale, (lim - y) * scale

    def circle(draw, c, r, **kw):
        x, y = px(*c)
        draw.ellipse([x - r * scale, y - r * scale, x + r * scale,
                      y + r * scale], **kw)

    gx, gy = px(traj.robot[0, T.GX], traj.robot[0, T.GY])
    frames = []
    for t in range(traj.humans.shape[0]):
        img = Image.new("RGB", (_PX, _PX), "white")
        draw = ImageDraw.Draw(img)
        draw.line([gx - 6, gy - 6, gx + 6, gy + 6], fill="red", width=3)
        draw.line([gx - 6, gy + 6, gx + 6, gy - 6], fill="red", width=3)
        for i in range(traj.humans.shape[1]):
            circle(draw, traj.humans[t, i, :2], traj.humans[t, i, T.RADIUS],
                   outline=_TAB10[i % 10], width=2)
        circle(draw, traj.robot[t, :2], traj.robot_radius, fill="gold")
        draw.text((8, 8), f"t = {t * traj.time_step:.1f} s "
                  f"({traj.outcome_name})", fill="black")
        frames.append(img)
    return frames


def render_video(traj: EpisodeTrajectory, path: str):
    """Animated episode (the reference's render('video')), one frame a
    step drawn with Pillow: a ``.gif`` written by Pillow, any other suffix
    encoded by ffmpeg, which must be on the PATH (it raises before drawing
    when it is not)."""
    gif = path.endswith(".gif")
    ffmpeg = None if gif else shutil.which("ffmpeg")
    if not gif and ffmpeg is None:
        raise RuntimeError(f"{path}: writing an mp4 needs ffmpeg, which is "
                           "not on the PATH; write a .gif instead")
    frames = _frames(traj)
    fps = int(1 / traj.time_step)
    if gif:
        frames[0].save(path, save_all=True, append_images=frames[1:],
                       duration=int(1000 * traj.time_step), loop=0)
        return
    subprocess.run(
        [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt",
         "rgb24", "-s", f"{_PX}x{_PX}", "-r", str(fps), "-i", "-",
         "-pix_fmt", "yuv420p", path],
        input=b"".join(f.tobytes() for f in frames), check=True)
