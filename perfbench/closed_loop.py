"""One client in a closed loop over a query suite, through ``GOpt.run``.

Set-up prepares every query of the mix cold (timed: the optimizer's
layer), then runs ``warm_passes`` passes of the suite (the first run of a
fused chain measures it on the per-hop loop, later runs dispatch it
fused).  The window runs passes, each a permutation of the suite drawn
from the seed, one query after another, each answer delivered to the
host before the next query is sent, until ``seconds`` have passed; the
query running then completes.  A query that stops at the engine's blow-up
guard counts as failed; any other exception ends the run.  Each query
completed adds its time from send to answer to ``latencies_ms``.  Traffic
keys: ``queries`` (names in the mix's queries file), ``warm_passes``.
Answers are checked by ``check.run_check``; the control is
``check.control_record``.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from perfbench.check import answer_key, binding_key
from perfbench.check import control_record, run_check as check  # noqa: F401

GUARD = "intermediate blow-up"


def run(system, config: dict, traffic: dict, queries: dict, seed: int,
        seconds: float, rec) -> dict:
    gopt = system.gopt
    kw = {"max_rows": config["max_rows"]}
    suite = [(n, queries[n]["text"], queries[n]["params"])
             for n in traffic["queries"]]
    bkeys = {n: binding_key(params) for n, _, params in suite}
    before = collections.Counter(gopt.compile_counters)
    prepare_ms = []
    for _, text, params in suite:
        t0 = time.perf_counter()
        gopt.prepare(text, params)
        prepare_ms.append((time.perf_counter() - t0) * 1e3)
    stages = dict(collections.Counter(gopt.compile_counters) - before)
    for _ in range(traffic["warm_passes"]):
        for _, text, params in suite:
            try:
                gopt.run(text, params, **kw)
            except RuntimeError as exc:
                if GUARD not in str(exc):
                    raise
    system.sync()
    rng = np.random.default_rng([seed, 2])
    # per (query, bindings): distinct answer -> how many times it came
    # (None: failed)
    answers: dict[tuple, collections.Counter] = {
        (n, bkeys[n]): collections.Counter() for n, _, _ in suite}
    spent = {n: 0.0 for n, _, _ in suite}
    slices: list[int] = []          # queries done by each whole second
    latencies_ms: list[float] = []
    errors: list[str] = []
    attempted = done = rows = 0
    rec.start()
    rec.window_starts()
    t_start = time.perf_counter()
    ns0 = time.time_ns()
    while time.perf_counter() - t_start < seconds:
        for i in rng.permutation(len(suite)).tolist():
            name, text, params = suite[i]
            attempted += 1
            t0 = time.perf_counter()
            with rec.span(f"query {name}"):
                try:
                    tbl, st = gopt.run(text, params, **kw)
                    answers[name, bkeys[name]][answer_key(tbl.cols)] += 1
                    rows += st.rows_produced
                    done += 1
                except RuntimeError as exc:
                    if GUARD not in str(exc):
                        raise
                    answers[name, bkeys[name]][None] += 1
                    errors.append(f"{name}: {str(exc)[:200]}")
            t1 = time.perf_counter()
            if len(latencies_ms) < done:        # it was answered
                latencies_ms.append((t1 - t0) * 1e3)
            spent[name] += t1 - t0
            rec.progress(t1 - t_start, done)
            while len(slices) < int(t1 - t_start):
                slices.append(attempted)
            if t1 - t_start >= seconds:
                break
    window_s = time.perf_counter() - t_start
    rec.windows.append((ns0, time.time_ns()))
    rec.stop(done)
    return {"window_s": window_s,
            "attempted": attempted, "failed": attempted - done,
            "queries_done": done, "rows_produced": rows,
            "prepare_ms": prepare_ms, "latencies_ms": latencies_ms,
            "answers": answers,
            "notes": {"errors": errors[:5], "compile_stages": stages,
                      "queries_by_second": slices,
                      "ms_per_query": {
                n: 1e3 * spent[n] / max(1, sum(answers[n, bkeys[n]].values()))
                for n in spent}}}
