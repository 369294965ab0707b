"""Device milliseconds of the planner's ``V_planning`` below the root a
step: the phase ``plan.v_planning`` of the evaluation's step graph
(``explorer.eval_step``, one step a replay)."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.v_planning")
