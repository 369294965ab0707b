"""What several per-layer readers share: the device's idle share of the
traced window, and the whole step's share of the float32 peak."""

from __future__ import annotations

from benchmarks.counters.peaks import F32_FLOPS


def idle_share(obs):
    """100·(1 − busy / window) over the traced window; None untraced."""
    t = obs.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(obs):
    """100 · model FLOPs of the window / (window seconds · the float32
    peak); None when nothing was counted."""
    flops = obs.counters.get("model_flops")
    if not flops or obs.window_s <= 0:
        return None
    return 100.0 * flops / obs.window_s / F32_FLOPS
