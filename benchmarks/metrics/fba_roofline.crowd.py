"""Kernel #1's share of its roofline (%): the least time its work needs
(``benchmarks/counters/fba.py``, from the cell's shapes) over its device
time a launch in the traced window, found by the kernel's name. The traced
launches must be the traced calls times the launches the captured chunks
hold; otherwise nothing is read."""

from benchmarks.counters import fba

KERNEL = "fused_block_attention_kernel"


def read(obs):
    t = obs.trace
    if t is None:
        return None
    hit = t.kernel(KERNEL)
    per_call = obs.counters.get("fba_launches", 0) / max(obs.calls, 1)
    traced = obs.counters.get("traced_calls", 0)
    if hit is None or hit[1] == 0 or hit[1] != traced * per_call:
        return None
    g = obs.config
    n, K = g["crowd"]["agents"], g["crowd"]["k_gnn"]
    d = g["gcn"]["final_state_dim"]
    least = fba.least_seconds(n, d, obs.traffic["block_B"],
                              obs.traffic["block_C"], n * K)
    return 100.0 * least / (hit[0] / hit[1])
