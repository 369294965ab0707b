"""Device milliseconds of the one-step lookahead's value net a step (the
rotated rows, with their maps, through SARL): the phase ``plan.value_net``
of the evaluation's step graph (``explorer.eval_step``, one step a
replay)."""

from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    return phase_ms_per_step(obs, "explorer.eval_step", "plan.value_net")
