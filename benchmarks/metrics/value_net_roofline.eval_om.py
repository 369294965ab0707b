"""The one-step lookahead's value net against the card's float32 peak
(%): a step's model FLOPs (``benchmarks/counters/onestep.py``: every case's
decision, all of it in the value net) over the device time of the phase
``plan.value_net`` in one replay of the evaluation's step graph."""

from benchmarks.counters import onestep
from benchmarks.counters.peaks import F32_FLOPS
from benchmarks.metrics._read import phase_ms_per_step


def read(obs):
    ms = phase_ms_per_step(obs, "explorer.eval_step", "plan.value_net")
    if not ms:
        return None
    flops = obs.traffic["cases"] * onestep.decision(obs.config)
    return 100.0 * flops / (ms / 1e3) / F32_FLOPS
