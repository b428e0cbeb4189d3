"""The traced window: ``torch.profiler`` on the card, spans on the host.

The closed loop (``closed_loop.py``) records host spans (a label, a start
and an end on the ``time.time_ns`` clock) around every call it makes into
the system, and marks the window that is measured.  With tracing on, the
profiler records the card's activity (CUDA activity only: kernels, copies,
fills); kineto puts device timestamps on the same clock as
``time.time_ns``, so device activity and host spans line up.  ``summary``
reduces both to what the metric readers and the result line's
``breakdown`` need.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time

COPY_PREFIXES = ("Memcpy", "Memset")     # device copies and fills
# the profiler covers the window's first seconds only: reading the trace of
# a whole 51-second closed loop (about 2.5M kernels) took most of a
# traced run's 235-250 s on an NVIDIA H100 80GB HBM3
TRACE_SECONDS = 20.0
TOP = 10
NAME_CHARS = 120

# kernel names of the port's hand-written kernels, as the profiler reports
# them (demangled; K1's sit in an anonymous namespace, templated)
KERNELS = {"k1": re.compile(r"\b(fence_kernel|search_kernel)\b")}


@dataclasses.dataclass
class Summary:
    window_s: float                  # measured host time the trace covers
    busy_s: float                    # union of device activity inside it
    kernels: int                     # kernel launches that ran inside it
    by_name: dict                    # kernel or copy name -> device seconds
    launches_by_name: dict           # kernel name -> launches
    idle_by_host: dict               # host span label -> idle device seconds

    def kernel_seconds(self, key: str) -> float:
        pat = KERNELS[key]
        return sum(s for n, s in self.by_name.items() if pat.search(n))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


class Recorder:
    """Host spans and measured windows of one run, and the profiler when
    tracing.  ``span`` is a context manager recording one flat span;
    ``windows`` holds the measured intervals.  The closed loop calls
    ``progress`` after each operation of the window; the profiler stops
    once ``TRACE_SECONDS`` of it have passed, and ``traced_done`` keeps
    how many operations had completed by then, the base of the traced
    per-operation metrics."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.first_timed: float | None = None   # perf_counter at window start
        self.spans: list[tuple[str, int, int]] = []
        self.windows: list[tuple[int, int]] = []
        self.traced_done: int | None = None
        self.stop_s = 0.0                       # reading the trace took
        self._trace_end = None                  # time_ns the profiler stopped
        self._prof = None
        self._events = None

    def start(self):
        """Start the profiler (when tracing), before the window."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()

    def window_starts(self):
        """Mark the first timed operation: set-up ends here."""
        if self.first_timed is None:
            self.first_timed = time.perf_counter()

    def progress(self, elapsed_s: float, done: int):
        if self._prof is not None and elapsed_s >= TRACE_SECONDS:
            self.stop(done)

    def stop(self, done: int):
        """Stop the profiler, if it runs, and read its device events."""
        if self._prof is not None:
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._trace_end = time.time_ns()
            self.traced_done = done
            self._prof.__exit__(None, None, None)
            self._events = [
                (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                 "copy" if e.name().startswith(COPY_PREFIXES) else "kernel")
                for e in self._prof.profiler.kineto_results.events()
                if str(e.device_type()).endswith("CUDA")]
            self._prof = None
            self.stop_s = time.perf_counter() - t0

    def span(self, label: str):
        return _Span(self, label)

    def summary(self) -> Summary | None:
        if self._events is None:
            return None
        traced = [(a, min(b, self._trace_end)) for a, b in self.windows
                  if a < self._trace_end]
        return summarize(self._events, traced, self.spans)


class _Span:
    def __init__(self, rec: Recorder, label: str):
        self.rec, self.label = rec, label

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec.spans.append((self.label, self.t0, time.time_ns()))


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(a: int, b: int, windows) -> list[tuple[int, int]]:
    return [(max(a, w0), min(b, w1)) for w0, w1 in windows
            if min(b, w1) > max(a, w0)]


def summarize(events, windows, spans) -> Summary:
    """Device events ``(name, start_ns, end_ns, kind)`` inside the
    measured ``windows``; idle time attributed to the host span that
    covers each idle gap's midpoint, or to ``between spans``.  Spans are
    flat (none inside another)."""
    windows = _union(windows)
    window_ns = sum(b - a for a, b in windows)
    busy, by_name, launches = [], {}, {}
    for name, a, b, kind in events:
        parts = _clip(a, b, windows)
        if not parts:
            continue
        busy.extend(parts)
        by_name[name] = by_name.get(name, 0.0) + sum(
            y - x for x, y in parts) * 1e-9
        if kind == "kernel":
            launches[name] = launches.get(name, 0) + 1
    busy = _union(busy)
    busy_ns = sum(b - a for a, b in busy)
    # idle gaps: the windows minus device activity
    gaps = []
    for w0, w1 in windows:
        t = w0
        for a, b in busy:
            if b <= w0 or a >= w1:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = (spans[i][0] if i >= 0 and spans[i][2] >= mid
                 else "between spans")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return Summary(window_s=window_ns * 1e-9, busy_s=busy_ns * 1e-9,
                   kernels=sum(launches.values()), by_name=by_name,
                   launches_by_name=launches, idle_by_host=idle)
