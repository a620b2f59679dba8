"""A slice of a run under ``torch.profiler``, kept in memory, and what the
per-layer metrics read from it.

The slice runs inside one ``record_function`` span, ``bench.slice``; its
host interval is the traced window. Device records are the kernels and the
copies (``Memcpy``/``Memset``) that CUPTI reports, read from the tracer's
own records (``kineto_results``): building the host op tree, as
``key_averages`` does, costs seconds for a train step's 20 k launches. A
device span that annotates a host span (``Optimizer.step#...``, the
benchmark's own ``bench.*``) is not a device operation and is left out.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SLICE = "bench.slice"
ANNOTATIONS = ("bench.", "Optimizer.", "ProfilerStep")


@dataclass
class Trace:
    """Device and host records of one slice; times in ns on the tracer's
    clock. ``kernels`` and ``copies`` are ``(name, start, duration)``,
    ``host`` is ``(name, start, end)``."""

    start: int
    end: int
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def device(self):
        return self.kernels + self.copies

    def busy_intervals(self):
        """The union of the device records within the window, sorted."""
        spans = sorted((max(s, self.start), min(s + d, self.end))
                       for _, s, d in self.device() if s + d > self.start and s < self.end)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, match) -> float:
        """Device seconds of the records whose name contains one of
        ``match``."""
        return sum(d for name, _, d in self.device() if any(m in name for m in match)) / 1e9

    def top_device_ops(self, n=10):
        """``[[name, seconds], ...]``, the device operations that took most
        time, summed by name."""
        total = {}
        for name, _, d in self.device():
            total[name] = total.get(name, 0) + d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], d / 1e9] for name, d in top]

    def idle_gaps(self, n=10):
        """``[[host op, seconds], ...]``: the window's idle time summed by
        the host operation that was running at the middle of each gap (the
        innermost, the one that started last; none where the interpreter
        ran between two recorded ops), longest first."""
        edges, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                edges.append((t, s))
            t = max(t, e)
        if self.end > t:
            edges.append((t, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        total, stack, i = {}, [], 0
        for s, e in sorted(edges, key=lambda g: (g[0] + g[1]) / 2):
            mid = (s + e) / 2
            j = bisect.bisect_right(starts, mid)
            stack.extend(host[i:j])
            i = max(i, j)
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(Python between ops)"
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], d / 1e9] for name, d in top]


def profile_slice(torch, fn) -> Trace:
    """Run ``fn()`` once under the profiler (CPU and, on the card, CUDA),
    synchronised at its end, and return its records."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return read_records(torch, prof.profiler.kineto_results.events())


def read_records(torch, events) -> Trace:
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels, copies, host, window = [], [], [], None
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda_type:
            if name.startswith(ANNOTATIONS) or "#" in name:
                continue
            (copies if name.startswith(("Memcpy", "Memset")) else kernels).append(
                (name, start, dur))
        elif name == SLICE:
            window = (start, start + dur)
        else:
            host.append((name, start, start + dur))
    if window is None:
        raise RuntimeError(f"the profiler lost the {SLICE} span")
    return Trace(window[0], window[1], kernels, copies, host)
