"""A driver module for the room test: one client through ``GOpt.run``
on the mix's one query, each read with a ``$pid`` of its own drawn from
the seed, checked by ``check.run_check`` with each answer's bindings."""
import collections
import time

import numpy as np

from perfbench import check as checks
from perfbench.check import answer_key, binding_key
from perfbench.reference.answers import rows
from perfbench.reference.graph import Graph
from perfbench.reference.suite import SUITE


def _pids(raw, seed: int):
    rng = np.random.default_rng([seed, 9])
    while True:
        yield int(rng.integers(raw.counts["PERSON"]))


def run(system, config, traffic, queries, seed, seconds, rec):
    name = traffic["queries"][0]
    text = queries[name]["text"]
    answers = collections.defaultdict(collections.Counter)
    done = 0
    pids = _pids(system.raw, seed)
    rec.start()
    rec.window_starts()
    t0 = time.perf_counter()
    ns0 = time.time_ns()
    while done < 2 or time.perf_counter() - t0 < seconds:
        params = {"pid": next(pids)}
        with rec.span(f"query {name}"):
            tbl, _ = system.gopt.run(text, params,
                                     max_rows=config["max_rows"])
        answers[name, binding_key(params)][answer_key(tbl.cols)] += 1
        done += 1
    window_s = time.perf_counter() - t0
    rec.windows.append((ns0, time.time_ns()))
    rec.stop(done)
    return {"window_s": window_s, "attempted": done, "failed": 0,
            "queries_done": done, "answers": dict(answers),
            "notes": {"system": system.built_by}}


def check(record, raw, queries):
    return checks.run_check(record, raw, queries)


def control_record(raw, traffic, queries, seed):
    g = Graph(raw, dedupe=False)
    name = traffic["queries"][0]
    pids = _pids(raw, seed)
    out = {}
    for _ in range(8):
        params = {"pid": next(pids)}
        out[name, binding_key(params)] = {
            answer_key(rows(SUITE[name](g, params))): 1}
    return {"failed": 0, "answers": out}
