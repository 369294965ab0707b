"""Device milliseconds of the unicycle planner's ``V_planning`` a step
(at w=8 the 8 kept nodes, their 648 children and 64 leaves): the phase
``plan.v_planning`` of the evaluation's step graph (``explorer.eval_step``,
one step a replay)."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.v_planning")
