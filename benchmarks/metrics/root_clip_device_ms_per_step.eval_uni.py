"""Device milliseconds of the unicycle planner's root clip a step (the
one-step values of all 81 (v, dθ) actions, the top w kept): the phase
``plan.root_clip`` of the evaluation's step graph (``explorer.eval_step``,
one step a replay)."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.root_clip")
