"""Profiling: the port's spans, counters and device phases, and the Chrome
trace of the train CLI (port of ``relationalgraphlearning_tpu/utils/
profiling.py``).

One process-wide switch, off at import (``enable``, ``disable``,
``enabled``). Off, ``span`` and ``device_phase`` cost one bool check and
hand back a shared null context, ``count`` returns at once, and a graph
captured then holds the same nodes as one captured without this module.
On:

- ``span(name)``: a host span on ``time.perf_counter``: its count, total
  seconds, self seconds (less what its child spans cover) and the spans it
  opened under. While ``torch.profiler`` records, it is also a
  ``record_function`` range, so the trace's device events sit on the same
  clock as the port's spans. ``annotate`` is the same function.
- ``count(name, n)``: adds ``n`` to a counter.
- ``device_counter(name, t)``: a device int64 scalar that a kernel adds
  into on every launch and every replay of a graph holding one, with the
  switch on or off; ``snapshot`` adds its value to the counter ``name``,
  ``reset`` zeroes it.
- ``device_phase(name, device)``: device time between two external CUDA
  timing events recorded inside a capture that ``captured.Graphed``
  started, so that each replay records them again as event nodes of the
  graph. The graph holds them (``PhaseReader``) and reads one replay's
  times just before its next replay, if that replay has completed
  (``query``, no wait), or else at ``snapshot``; a replay still running
  then is skipped and counted as such. Outside such a capture, and on the
  CPU, a phase records nothing.

Everything stays in memory until ``snapshot()``, which waits for the device
and returns it as plain data; ``reset()`` empties it. Nothing here
synchronises the device except ``snapshot``.

``trace(log_dir)`` records the enclosed block with ``torch.profiler`` (the
host's operators and, on the card, its kernels) with the switch on, and
writes a Chrome trace, ``<log_dir>/trace.json`` (Perfetto or
``chrome://tracing`` read it), in place of the reference's
``jax.profiler`` trace. The train CLI exposes ``--profile_dir``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
import weakref

import torch

TRACE_FILE = "trace.json"

_on = False
_lock = threading.Lock()
_local = threading.local()  # .stack: open spans; .sink: a capture's phases
_NULL = contextlib.nullcontext()

_spans: dict = {}  # name -> [count, total_s, self_s, {parent: count}]
_counters: dict = {}
_graphs: dict = {}  # graph name -> replays, read, skipped, phase times
_device_counters: list = []  # (name, device int64 scalar a kernel adds to)
_readers = weakref.WeakSet()  # every PhaseReader, for snapshot()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Empty the registry (the graphs keep their phase events; a replay
    pending now is not read)."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _graphs.clear()
        for r in list(_readers):
            r.pending = False
        for _, t in _device_counters:
            t.zero_()


# --------------------------------------------------------------- host spans
def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "t0", "child", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.child = 0.0
        _stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child += dt
        with _lock:
            s = _spans.get(self.name)
            if s is None:
                s = _spans[self.name] = [0, 0.0, 0.0, {}]
            s[0] += 1
            s[1] += dt
            s[2] += dt - self.child
            p = parent.name if parent is not None else ""
            s[3][p] = s[3].get(p, 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A host span (a context manager); the shared null context when
    off."""
    return _Span(name) if _on else _NULL


annotate = span


def spanned(name: str):
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Stopwatch:
    """A span that keeps its own host total, ``seconds``, with the switch
    off too (two clock reads a use): for the few boundaries an operator's
    log reports."""

    def __init__(self, name: str):
        self.name, self.seconds = name, 0.0

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def count(name: str, n: float = 1) -> None:
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def device_counter(name: str, t: torch.Tensor) -> None:
    """Read the device int64 scalar ``t`` that a kernel adds into as the
    counter ``name`` (``snapshot``; ``reset`` zeroes it)."""
    with _lock:
        _device_counters.append((name, t))


# ------------------------------------------------------------ device phases
class _Phase:
    __slots__ = ("name", "sink", "start")

    def __init__(self, name: str, sink: list):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        self.sink.append((self.name, self.start, end))
        return False


def device_phase(name: str, device: torch.device):
    """Device time of the enclosed launches, replay by replay (a context
    manager); the shared null context when off, on the CPU, or outside a
    capture that ``captured.Graphed`` started."""
    if not _on or device.type != "cuda":
        return _NULL
    sink = getattr(_local, "sink", None)
    return _NULL if sink is None else _Phase(name, sink)


@contextlib.contextmanager
def capturing():
    """Collect the device phases of a capture on this thread -> the list
    of (name, start event, end event) the capture recorded."""
    phases: list = []
    outer = getattr(_local, "sink", None)
    _local.sink = phases
    try:
        yield phases
    finally:
        _local.sink = outer


class PhaseReader:
    """The phase events of one captured graph, read replay by replay under
    the graph's ``name``: call ``replayed()`` just before each replay."""

    def __init__(self, name: str, phases: list):
        self.name, self.phases = name, phases
        self.pending = False
        _readers.add(self)

    def replayed(self) -> None:
        if not _on:
            self.pending = False
            return
        with _lock:
            g = _graph(self.name)
            if self.pending:
                if self.phases[-1][2].query():
                    self._read(g)
                else:
                    g["skipped"] += 1
            g["replays"] += 1
            self.pending = True

    def _read(self, g: dict) -> None:
        """One complete replay's phase times (under ``_lock``)."""
        for name, start, end in self.phases:
            p = g["phases"].setdefault(name, {"ms": 0.0, "count": 0})
            p["ms"] += start.elapsed_time(end)
            p["count"] += 1
        g["read"] += 1
        self.pending = False


def _graph(name: str) -> dict:
    g = _graphs.get(name)
    if g is None:
        g = _graphs[name] = {"replays": 0, "read": 0, "skipped": 0,
                             "phases": {}}
    return g


def snapshot() -> dict:
    """Wait for the device, read every pending phase, and return the
    registry as plain data: ``spans`` {name: count, total_s, self_s,
    parents {parent or "": count}}, ``counters``, ``graphs`` {graph name:
    replays, read, skipped, phases {name: ms, count} summed over the
    replays read}}."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with _lock:
        for r in list(_readers):
            if r.pending:
                r._read(_graph(r.name))
        counters = dict(_counters)
        for name, t in _device_counters:
            counters[name] = counters.get(name, 0) + int(t)
        return {
            "spans": {n: {"count": s[0], "total_s": s[1], "self_s": s[2],
                          "parents": dict(s[3])} for n, s in _spans.items()},
            "counters": counters,
            "graphs": {n: {**g, "phases": {p: dict(v) for p, v
                                           in g["phases"].items()}}
                       for n, g in _graphs.items()}}


# -------------------------------------------------------------------- trace
@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block, the switch on, when ``log_dir`` is set;
    no-op otherwise."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
