"""The comparison that decides ``correct``, and its control.

Two numbers are compared, each with the limit 0:

- ``wrong_answers``: every answer of the window against the plain
  reference's (``reference/``) answer to its query, run with the bindings
  the answer was asked with (a record's answers are keyed by query and
  bindings);
- ``failed_requests``: the window's queries that gave no answer (a stop at
  the engine's blow-up guard).  The mix leaves out the queries that stop
  at the guard, so a sound run answers every query; any other failure
  ends the run.

``control_record`` builds the record that the reference itself gives with
one of the configuration's guarantees broken: the store keeping duplicate
edges (a store keeps each edge once).  The check must find it not correct.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.answers import rows
from perfbench.reference.graph import Graph
from perfbench.reference.suite import SUITE


def answer_key(cols: dict) -> tuple:
    """An answer's columns as a hashable key (equal answers, one key)."""
    arrays = {k: np.asarray(v) for k, v in cols.items()}
    return tuple((k, a.dtype.str, a.tobytes())
                 for k, a in sorted(arrays.items()))


def answer_cols(key: tuple) -> dict:
    return {k: np.frombuffer(b, dtype=np.dtype(dt)) for k, dt, b in key}


def binding_key(params: dict | None) -> tuple:
    """A read's bindings as a hashable key (``dict(key)`` gives them
    back)."""
    return tuple(sorted((params or {}).items()))


def run_check(record: dict, raw, queries: dict):
    g = Graph(raw)
    wrong = checked = 0
    first = None
    for (name, bkey), answers in record["answers"].items():
        want = SUITE[name](g, dict(bkey))
        for key, n in answers.items():
            if key is None:             # no answer: ``failed_requests``
                continue
            m = want.mismatch(answer_cols(key))
            checked += n
            if m is not None:
                wrong += n
                first = first or f"{name} {dict(bkey)}: {m}"
    checks = [("wrong_answers", wrong, 0),
              ("failed_requests", record["failed"], 0)]
    return checks, {"answers_checked": checked,
                    "bindings_checked": len(record["answers"]),
                    "first_wrong": first}


def control_record(raw, traffic: dict, queries: dict, seed: int) -> dict:
    """The reference in the system's place, one guarantee broken (the
    mix's fixed bindings: ``seed`` draws nothing here)."""
    g = Graph(raw, dedupe=False)
    return {"failed": 0, "answers": {
        (n, binding_key(queries[n]["params"])): {
            answer_key(rows(SUITE[n](g, queries[n]["params"]))): 1}
        for n in traffic["queries"]}}
