"""Device milliseconds of the planner's state predictor a step (its RGL
forwards for the root and each expanded node: 9 a decision at d=2, w=8):
the phase ``plan.predict`` of the evaluation's step graph
(``explorer.eval_step``, one step a replay), summed over its two calls,
which lie inside ``plan.root_clip`` and ``plan.v_planning``. A program
without the phase reads nothing."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.predict")
