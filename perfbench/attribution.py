"""The card's idle time put down to the program's own spans.

``trace.summarize`` gives each idle gap of the traced window to the flat
``query …`` span around it.  Here each completed query also hands over its
``ExecStats.spans`` (the port's span tree of one ``GOpt.run``, stamped on
the clock the profiler gives its events) and its host syncs, and each gap
goes to the **innermost program span** covering its midpoint:

- ``optimizer``: a ``plan`` span (the prepared-plan lookup);
- ``ops``: an operator's span (a child of ``pattern`` or ``tail``) or a
  step inside one (``INTERSECT(...)``, ``FILTER``);
- ``engine``: the rest of ``gopt.run`` (``engine.setup``, ``pattern`` and
  ``tail`` outside any operator, ``deliver``, the root's own time);
- ``outside the program``: inside a ``query …`` span, outside ``gopt.run``
  (the closed loop's own work, such as hashing the answer);
- ``between queries``: outside every ``query …`` span.

The five add up to the traced window's idle time.  The harness does not
call this module: its run hands the readers no program spans (see PERF.md,
Open questions).  Run it on its own, on the card, from the repository's
root:

    python3 -m perfbench.attribution --workload <cell> --seed <n> \\
        --seconds <s> [--trace 0|1]

It builds and drives the cell as ``run.py`` does, with the ``GOpt`` behind
a tap that keeps each completed query's record, and prints one JSON line:
the idle split per traced query, the operators with the most idle time,
host syncs per query by phase and by query, and (``--trace 0``) just the
sync counts.  It checks no answers: ``run.py`` does.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from perfbench.trace import Recorder, _union

LAYERS = ("optimizer", "engine", "ops")
OUTSIDE = "outside the program"
BETWEEN = "between queries"
TOP = 10


class SpanRecorder(Recorder):
    """A ``Recorder`` that also keeps the program's records: the spans of
    every query completed while the profiler runs (``span_layers``), and
    the host syncs of every query completed in the window."""

    def __init__(self, trace: bool):
        super().__init__(trace)
        self.program_spans: list[tuple] = []  # (name, a, b, layer, query)
        self.host_syncs = 0
        self.syncs_by_phase: collections.Counter = collections.Counter()
        self.h2d = 0                # staging copies (a sync unless empty)
        self.syncs_by_query: dict[str, list[int]] = {}
        self._counting = False

    def start(self):
        self._counting = True
        super().start()

    def add(self, query: str, stats):
        """Take one completed query's ``ExecStats``."""
        if not self._counting:
            return
        self.host_syncs += stats.host_syncs
        self.syncs_by_query.setdefault(query, []).append(stats.host_syncs)
        for key, v in (stats.transfers or {}).items():
            phase, kind = key.rsplit(":", 1)
            if kind == "sync":
                self.syncs_by_phase[phase] += v["calls"]
            elif kind == "h2d":
                self.h2d += v["calls"]
        if self.trace and self.traced_done is None:   # the profiler runs
            self.program_spans.extend(span_layers(stats.spans, query))

    def traced(self) -> tuple | None:
        """The device events and the traced windows ``summary()`` reads,
        or None before the trace is read: the one place this class reads
        ``Recorder``'s own state (a test holds it to ``summary()``)."""
        if self._events is None:
            return None
        return self._events, [(a, min(b, self._trace_end))
                              for a, b in self.windows
                              if a < self._trace_end]

    def attribution(self) -> dict | None:
        got = self.traced()
        if got is None:
            return None
        return attribute(*got, self.spans, self.program_spans)


def span_layers(spans, query: str = "") -> list[tuple]:
    """``(name, start_ns, end_ns, layer, query)`` for each closed span of
    one run's ``ExecStats.spans``."""
    layers: list[str] = []
    out = []
    for name, a, b, parent in spans:
        if parent < 0:
            layer = "engine"
        elif name == "plan":
            layer = "optimizer"
        elif layers[parent] == "ops" or spans[parent][0] in ("pattern",
                                                             "tail"):
            layer = "ops"
        else:
            layer = layers[parent]
        layers.append(layer)
        if b:
            out.append((name, a, b, layer, query))
    return out


def _innermost(spans) -> list[tuple]:
    """Disjoint pieces of time in order, each ``(start, end, span)`` with
    the innermost span over it.  Spans nest or do not meet (one run's
    tree; runs one after another)."""
    pieces = []
    stack: list[tuple] = []
    t = None
    for sp in sorted(spans, key=lambda s: (s[1], -s[2])):
        a = sp[1]
        while stack and stack[-1][2] <= a:
            top = stack.pop()
            if top[2] > t:
                pieces.append((t, top[2], top))
            t = top[2]
        if stack and a > t:
            pieces.append((t, a, stack[-1]))
        stack.append(sp)
        t = a
    while stack:
        top = stack.pop()
        if top[2] > t:
            pieces.append((t, top[2], top))
        t = max(t, top[2])
    return pieces


def _gaps(events, windows):
    """Busy nanoseconds and the idle gaps ``(starts, ends)`` of the
    windows: the windows minus the union of device activity, as
    ``trace.summarize`` finds them, in arrays."""
    ev = np.array([(a, b) for _, a, b, _ in events],
                  dtype=np.int64).reshape(-1, 2)
    busy_ns, starts, ends = 0, [], []
    for w0, w1 in _union(windows):
        a, b = np.clip(ev[:, 0], w0, w1), np.clip(ev[:, 1], w0, w1)
        keep = b > a
        order = np.argsort(a[keep], kind="stable")
        a, b = a[keep][order], b[keep][order]
        reach = np.maximum.accumulate(b) if len(b) else b
        first = np.ones(len(a), dtype=bool)    # a block of activity begins
        first[1:] = a[1:] > reach[:-1]
        at = np.flatnonzero(first)
        b0 = a[at]
        b1 = reach[np.r_[at[1:] - 1, len(a) - 1]] if len(a) else reach
        busy_ns += int((b1 - b0).sum())
        ga, gb = np.r_[w0, b1], np.r_[b0, w1]
        starts.append(ga[gb > ga])
        ends.append(gb[gb > ga])
    return busy_ns, np.concatenate(starts), np.concatenate(ends)


def attribute(events, windows, query_spans, program_spans) -> dict:
    """Idle gaps of the ``windows`` (device ``events`` as ``trace``
    records them) put down to the innermost program span covering each
    gap's midpoint; ``query_spans`` are the closed loop's flat spans,
    ``program_spans`` ``span_layers`` records.  Seconds, unrounded."""
    busy_ns, ga, gb = _gaps(events, windows)
    mid, ns = (ga + gb) // 2, gb - ga
    pieces = _innermost(program_spans)
    p0 = np.array([p[0] for p in pieces], dtype=np.int64)
    p1 = np.array([p[1] for p in pieces], dtype=np.int64)
    i = np.searchsorted(p0, mid, side="right") - 1
    hit = i >= 0
    hit[hit] = p1[i[hit]] > mid[hit]
    by_layer = dict.fromkeys(LAYERS + (OUTSIDE, BETWEEN), 0.0)
    by_op: dict[str, float] = {}
    by_query_op: dict[str, float] = {}
    # one sum a piece, then one a label
    piece_ns = np.bincount(i[hit], weights=ns[hit], minlength=len(pieces))
    for (_, _, (name, _, _, layer, query)), v in zip(pieces, piece_ns):
        if not v:
            continue
        secs = v * 1e-9
        by_layer[layer] += secs
        if layer == "ops":
            by_op[name] = by_op.get(name, 0.0) + secs
            key = f"{query} {name}"
            by_query_op[key] = by_query_op.get(key, 0.0) + secs
    queries = sorted(query_spans, key=lambda s: s[1])
    q0 = np.array([q[1] for q in queries], dtype=np.int64)
    q1 = np.array([q[2] for q in queries], dtype=np.int64)
    rest = ~hit
    j = np.searchsorted(q0, mid[rest], side="right") - 1
    inside = j >= 0
    inside[inside] = q1[j[inside]] >= mid[rest][inside]
    by_layer[OUTSIDE] = int(ns[rest][inside].sum()) * 1e-9
    by_layer[BETWEEN] = int(ns[rest][~inside].sum()) * 1e-9
    window_ns = sum(b - a for a, b in _union(windows))
    return {"window_s": window_ns * 1e-9, "busy_s": busy_ns * 1e-9,
            "idle_s": by_layer,
            "idle_by_op": _top(by_op), "idle_by_query_op": _top(by_query_op)}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


class Tap:
    """The system's ``GOpt`` with each ``run``'s record handed to the
    recorder under its query's name."""

    def __init__(self, gopt, rec: SpanRecorder, names: dict):
        self._gopt, self._rec, self._names = gopt, rec, names

    def run(self, text, *a, **k):
        out = self._gopt.run(text, *a, **k)
        self._rec.add(self._names.get(text, "?"), out[1])
        return out

    def __getattr__(self, name):
        return getattr(self._gopt, name)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str | None = None, sizes: dict | None = None) -> dict:
    """One run of the cell with the program's records kept; returns the
    line ``main`` prints (``device="cpu"`` and ``sizes`` for the tests)."""
    from perfbench import bench, closed_loop, harness, system
    spec = bench.load()
    cell = bench.cell(spec, cell_name)
    cfg = bench.config(spec, cell["config"])
    trf = bench.traffic(cell["traffic"])
    for key, value in (sizes or {}).items():
        (cfg if key in cfg else trf)[key] = value
    qs = harness.queries()
    rec = SpanRecorder(trace)
    sut = system.build(cfg, seed, device)
    sut.gopt = Tap(sut.gopt, rec, {q["text"]: n for n, q in qs.items()})
    record = closed_loop.run(sut, cfg, trf, qs, seed, seconds, rec)
    done = record["queries_done"]
    line = {"cell": cell_name, "seed": seed, "queries_done": done,
            "window_s": record["window_s"],
            "host_syncs_per_query": rec.host_syncs / done if done else None,
            "host_syncs_by_phase": {k: v / done for k, v in
                                    sorted(rec.syncs_by_phase.items())}
            if done else {},
            "h2d_per_query": rec.h2d / done if done else None,
            "host_syncs_by_query": {
                n: sum(v) / len(v) for n, v in sorted(
                    rec.syncs_by_query.items())}}
    old = rec.summary()
    t0 = time.perf_counter()
    att = rec.attribution()
    if att is not None:
        n = rec.traced_done
        idle = att["idle_s"]
        line.update({
            "traced_done": n, "traced_window_s": att["window_s"],
            # the accepted reader's number, from trace.summarize
            "device.idle_pct.cgp": 100.0 * (1.0 - old.busy_s / old.window_s),
            "idle_ms_per_query": {k: 1e3 * idle[k] / n for k in LAYERS},
            "idle_outside_program_s": idle[OUTSIDE],
            "idle_between_queries_s": idle[BETWEEN],
            # the split's sum against the accepted reader's idle seconds
            "idle_split_s": sum(idle.values()),
            "idle_summary_s": old.window_s - old.busy_s,
            "idle_by_op": att["idle_by_op"],
            "idle_by_query_op": att["idle_by_query_op"],
            "trace_read_s": rec.stop_s,
            "attribution_s": time.perf_counter() - t0})
    return line


def main(argv=None) -> int:
    import argparse
    import json
    # the paths and the environment of a run (run.py's module set-up)
    from perfbench import run  # noqa: F401
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    print(json.dumps(run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
