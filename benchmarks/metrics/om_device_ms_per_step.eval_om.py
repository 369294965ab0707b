"""Device milliseconds of the one-step lookahead's occupancy maps a step:
the phase ``plan.om`` of the evaluation's step graph
(``explorer.eval_step``, one step a replay)."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.om")
