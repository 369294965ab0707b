"""MP-RGL's value kernel against the card's float32 peak (%): the
operations of a step's value calls (``benchmarks/counters/rgl_value.py``:
the planning tree's forwards, each group's humans embedded once, for every
case's decision) over the kernel's device time a step in the traced
window, found by the kernel's name. The traced launches must be the traced
calls' steps times the launches a decision holds; otherwise nothing is
read."""

from benchmarks.counters import rgl_value
from benchmarks.counters.peaks import F32_FLOPS

KERNEL = "rgl_value_kernel"


def read(obs):
    t = obs.trace
    if t is None:
        return None
    hit = t.kernel(KERNEL)
    env = obs.config["env"]
    steps = round(env["time_limit"] / env["time_step"]) \
        * obs.counters.get("traced_calls", 0)
    if hit is None or not steps or \
            hit[1] != steps * rgl_value.launches(obs.config):
        return None
    ops = obs.traffic["cases"] * rgl_value.decision(obs.config)
    return 100.0 * ops / (hit[0] / steps) / F32_FLOPS
