"""What a query's answer must be, and the comparison with what came back.

``Exact``: the columns, row for row (a count, or a result whose ORDER BY
fixes every row).  ``TopK``: an ``ORDER BY value LIMIT k`` over groups,
where ties leave the choice of rows open: the rows that came back must be
distinct groups, each with its own value, ordered by value, and their
values must be the ``k`` best values of all groups.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Exact:
    cols: dict[str, np.ndarray]

    def mismatch(self, got: dict[str, np.ndarray]) -> str | None:
        if set(got) != set(self.cols):
            return f"columns {sorted(got)} != {sorted(self.cols)}"
        for k, want in self.cols.items():
            have = np.asarray(got[k])
            if have.shape != want.shape or not np.array_equal(have, want):
                return (f"column {k}: {have[:8].tolist()} (n={have.shape[0]})"
                        f" != {want[:8].tolist()} (n={want.shape[0]})")
        return None


@dataclasses.dataclass
class TopK:
    keys: tuple[str, ...]          # group key columns
    value: str                     # the aggregate ORDER BY sorts on
    groups: dict[tuple, int]       # every group's value
    k: int
    descending: bool

    def best(self) -> list[int]:
        vals = sorted(self.groups.values(), reverse=self.descending)
        return vals[:self.k]

    def mismatch(self, got: dict[str, np.ndarray]) -> str | None:
        want_cols = set(self.keys) | {self.value}
        if set(got) != want_cols:
            return f"columns {sorted(got)} != {sorted(want_cols)}"
        vals = np.asarray(got[self.value]).tolist()
        keys = list(zip(*(np.asarray(got[c]).tolist() for c in self.keys)))
        if len(set(keys)) != len(keys):
            return "a group came back twice"
        for key, v in zip(keys, vals):
            if self.groups.get(key) != v:
                return f"group {key}: {v} != {self.groups.get(key)}"
        order = sorted(vals, reverse=self.descending)
        if vals != order:
            return f"rows not ordered by {self.value}: {vals[:8]}"
        if vals != self.best():
            return f"values {vals[:8]} are not the best {self.best()[:8]}"
        return None


def topk(keys: tuple[str, ...], value: str, key_cols: list[np.ndarray],
         values: np.ndarray, k: int, descending: bool) -> TopK:
    """A ``TopK`` from parallel key columns and values (groups whose value
    is 0 produced no row and are no group)."""
    keep = values != 0
    groups = dict(zip(zip(*(np.asarray(c)[keep].tolist() for c in key_cols)),
                      np.asarray(values)[keep].tolist()))
    return TopK(keys, value, groups, k, descending)


def rows(expected) -> dict[str, np.ndarray]:
    """Concrete rows for an expected answer: ``Exact``'s columns, or a
    ``TopK``'s best groups, ties broken by key."""
    if isinstance(expected, Exact):
        return expected.cols
    sign = -1 if expected.descending else 1
    best = sorted(expected.groups.items(),
                  key=lambda kv: (sign * kv[1], kv[0]))[:expected.k]
    cols = {c: np.array([k[i] for k, _ in best], dtype=np.int64)
            for i, c in enumerate(expected.keys)}
    cols[expected.value] = np.array([v for _, v in best], dtype=np.int64)
    return cols
