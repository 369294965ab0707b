"""What several per-layer readers share: the device's idle share of the
traced window, the whole step's share of the float32 peak, and the port's
own spans and device phases over the window (``obs.program``, the port's
``profiling.snapshot()``; None in an untraced run)."""

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


def host_ms_per(obs, spans, per):
    """Milliseconds of the port's host spans ``spans`` (their totals,
    summed) over the window, per ``per`` units of the window's work (its
    calls, or a driver counter); None when a span or the work is
    missing."""
    prog = obs.program
    if prog is None or not per or \
            not all(s in prog["spans"] for s in spans):
        return None
    return 1000.0 * sum(prog["spans"][s]["total_s"] for s in spans) / per


def phase_ms_per_step(obs, graph: str, phase: str):
    """Device milliseconds of the phase ``phase`` of the captured graph
    ``graph``, whose replay is one step: its time in one replay, the mean
    over the replays read; None when none was read."""
    prog = obs.program
    g = prog["graphs"].get(graph) if prog is not None else None
    if not g or not g["read"] or phase not in g["phases"]:
        return None
    return g["phases"][phase]["ms"] / g["read"]
