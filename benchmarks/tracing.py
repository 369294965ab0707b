"""The traced window: ``torch.profiler`` (CUPTI) over the first part of
the measured window, reduced to device busy time, time by kernel and the
longest idle gaps.

Busy time is the union of the intervals in which a device operation
(kernel, copy, set) ran; the idle share is 1 − busy / window, the
arithmetic of ``chip_smoke.py --profile`` applied to the traced window. A
gap is named by the innermost host span (``harness.Window.span``) open
when it began. The profiler records ``budget_s`` (closing at the next call boundary
after it), because a window of the small kernels these cells run holds
millions of device events.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional


class TraceSummary(NamedTuple):
    busy_s: float
    window_s: float
    kernels: dict  # name -> (seconds, launches)
    gaps: list  # [(span name, seconds)], longest first

    def kernel(self, part: str) -> Optional[tuple]:
        """(seconds, launches) summed over the kernels whose name holds
        ``part``, or None."""
        hits = [v for k, v in self.kernels.items() if part in k]
        if not hits:
            return None
        return (sum(h[0] for h in hits), sum(h[1] for h in hits))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


class Tracer:
    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.prof = None
        self.active = False
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        if self.active and time.perf_counter() - self.t0 >= self.budget_s:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.active = False
        self.prof.__exit__(None, None, None)

    def summary(self, span_names) -> TraceSummary:
        """Reduce the trace; ``span_names``: the host spans' names."""
        from torch.autograd import DeviceType
        device, spans = [], []
        kernels: dict = {}
        for ev in self.prof.events():
            start, end = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                if ev.name in span_names:  # a host span's device copy
                    continue
                device.append((start, end))
                s, c = kernels.get(ev.name, (0.0, 0))
                kernels[ev.name] = (s + (end - start) / 1e6, c + 1)
            elif ev.name in span_names:
                spans.append((start, end, ev.name))
        device.sort()
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e in device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        named = []
        for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            inner = [(e - s, n) for s, e, n in spans if s <= gs < e]
            named.append((min(inner)[1] if inner else "outside any span",
                          (ge - gs) / 1e6))
        return TraceSummary(busy / 1e6, self.t1 - self.t0, kernels, named)
