"""Profiling hooks (port of
``relationalgraphlearning_tpu/utils/profiling.py``).

``trace(log_dir)`` records the enclosed block with ``torch.profiler`` (the
host's operators and, on the card, its kernels) and writes a Chrome trace,
``<log_dir>/trace.json`` (Perfetto or ``chrome://tracing`` read it), in
place of the reference's ``jax.profiler`` trace; ``annotate(name)`` names a
region of it. The train CLI exposes ``--profile_dir``.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region of the trace (use as a context manager)."""
    return torch.profiler.record_function(name)
