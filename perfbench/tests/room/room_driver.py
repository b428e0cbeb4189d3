"""A driver module for the room test: one client through ``GOpt.run`` on
the mix's one query, each read with a ``$pid`` of its own drawn from the
seed, checked against a plain numpy count of the person's friends'
friends on the data the system served (``raw``)."""
import collections
import hashlib
import time

import numpy as np

from perfbench.check import answer_cols, answer_key, binding_key

KNOWS = ("PERSON", "KNOWS", "PERSON")


def _pids(raw, seed: int):
    rng = np.random.default_rng([seed, 9])
    while True:
        yield int(rng.integers(raw.counts["PERSON"]))


def fof_count(raw, pid: int, dedupe: bool = True) -> int:
    """Walks p -[:KNOWS]-> f -[:KNOWS]-> ff from person ``pid``: the sum of
    the out-degrees of p's out-neighbours, each edge counted once (a store
    keeps each edge once) or, with ``dedupe=False``, as often as it was
    generated."""
    src, dst = raw.edges[KNOWS]
    n = raw.counts["PERSON"]
    keys = src.astype(np.int64) * n + dst
    if dedupe:
        keys = np.unique(keys)
    s, d = keys // n, keys % n
    return int(np.bincount(s, minlength=n)[d[s == pid]].sum())


def fingerprint(raw) -> str:
    """A digest of the data's edge lists."""
    h = hashlib.sha256()
    for t in sorted(raw.edges):
        for a in raw.edges[t]:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def run(system, config, traffic, queries, seed, seconds, rec):
    name = traffic["queries"][0]
    text = queries[name]["text"]
    answers = collections.defaultdict(collections.Counter)
    latencies_ms = []
    pids = _pids(system.raw, seed)
    rec.start()
    rec.window_starts()
    t_start = time.perf_counter()
    ns0 = time.time_ns()
    while len(latencies_ms) < 2 or time.perf_counter() - t_start < seconds:
        params = {"pid": next(pids)}
        t0 = time.perf_counter()
        with rec.span(f"query {name}"):
            tbl, _ = system.gopt.run(text, params,
                                     max_rows=config["max_rows"])
        latencies_ms.append((time.perf_counter() - t0) * 1e3)
        answers[name, binding_key(params)][answer_key(tbl.cols)] += 1
    window_s = time.perf_counter() - t_start
    rec.windows.append((ns0, time.time_ns()))
    done = len(latencies_ms)
    rec.stop(done)
    return {"window_s": window_s, "attempted": done, "failed": 0,
            "queries_done": done, "answers": dict(answers),
            "latencies_ms": latencies_ms}


def check(record, raw, queries):
    wrong = checked = 0
    for (_, bkey), answers in record["answers"].items():
        want = fof_count(raw, dict(bkey)["pid"])
        for key, n in answers.items():
            checked += n
            if answer_cols(key)["c"].tolist() != [want]:
                wrong += n
    checks = [("wrong_answers", wrong, 0),
              ("failed_requests", record["failed"], 0)]
    return checks, {"answers_checked": checked,
                    "bindings_checked": len(record["answers"]),
                    "raw_fingerprint": fingerprint(raw)}


def control_record(raw, traffic, queries, seed):
    """The reference in the system's place, with each edge counted as
    often as it was generated (a store keeps each edge once)."""
    name = traffic["queries"][0]
    pids = _pids(raw, seed)
    out = {}
    for _ in range(8):
        params = {"pid": next(pids)}
        c = np.array([fof_count(raw, params["pid"], dedupe=False)])
        out[name, binding_key(params)] = {answer_key({"c": c}): 1}
    return {"failed": 0, "answers": out}
