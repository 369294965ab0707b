"""The MP-RGL comparisons that decide ``correct``: a sample of the timed
path's decisions and env steps, each judged by the plain reference
(``benchmarks/reference/mprl.py``) from the state the program was in.

- A decision: how far the reference's planning return of the program's
  action lies below the reference's best (``Planner.gap``, which excuses a
  near tie at the root's clip). An explored decision must be the explored
  action exactly.
- An env step: the largest difference of the next robot and human states
  (and of the reward, where the program records it) from the reference's
  step with the program's action; the outcomes must agree exactly.

``control`` swaps the program's answers for the reference's own computed
with TF32 matmuls, the precision below the configuration's float32.
"""

from __future__ import annotations

import contextlib

import torch

from benchmarks.reference import mprl as ref


@contextlib.contextmanager
def tf32():
    """Matmuls in TF32 (the control's precision)."""
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def control_actions(planner: ref.Planner, robot, humans) -> torch.Tensor:
    with tf32():
        return planner.decide(robot, humans)[0]


def decision_gap(planner: ref.Planner, robot, humans, actions,
                 explored=None, explore_actions=None) -> float:
    """The widest gap over the sampled decisions [S] (0 when none)."""
    if robot.shape[0] == 0:
        return 0.0
    greedy = torch.ones(robot.shape[0], dtype=torch.bool,
                        device=robot.device)
    worst = 0.0
    if explored is not None:
        greedy = ~explored
        if explored.any():
            same = (actions[explored] == explore_actions[explored]).all(-1)
            worst = 0.0 if bool(same.all()) else ref.NOT_PLANNED
    if greedy.any():
        _, v1, q = planner.decide(robot[greedy], humans[greedy])
        gaps = planner.gap(v1, q, actions[greedy])
        worst = max(worst, float(gaps.clamp(min=0).max()))
    return worst


def step_errors(env: dict, robot, humans, step, action, next_robot,
                next_humans, done, outcome, reward=None
                ) -> tuple[float, int]:
    """(largest float difference, outcomes that differ) of the program's
    step against the reference's on live envs. ``next_humans`` may be the
    observable [S, N, 5] or the full [S, N, 9] states."""
    if robot.shape[0] == 0:
        return 0.0, 0
    out = ref.env_step(robot, humans, step, action, env)
    k = next_humans.shape[-1]
    diffs = [(out.robot - next_robot).abs().max(),
             (out.humans[..., :k] - next_humans).abs().max()]
    if reward is not None:
        diffs.append((out.reward - reward).abs().max())
    err = float(torch.stack(diffs).max())
    bad = int(((out.done != done) | (torch.where(out.done, out.outcome, 0)
                                     != torch.where(done, outcome, 0))
               ).sum())
    return err, bad
