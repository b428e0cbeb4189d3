"""Adjacency of a generated graph.

Global vertex ids follow the generator's layout (``snb.RawGraph.offsets``).
A store keeps each ``(src, label, dst)`` once, so the base deduplicates
each edge list; ``dedupe=False`` keeps the duplicates (the control's
broken guarantee).  Every neighbour list is a multiset: with duplicates
kept, a pair counts as often as it was generated.
"""
from __future__ import annotations

import numpy as np

from perfbench import snb

SHIFT = np.int64(1 << 32)      # pair key: src * 2**32 + dst (ids < 2**31)


def gather(indptr: np.ndarray, idx: np.ndarray, rows: np.ndarray):
    """``(rep, values)``: for each ``rows[i]``, its ``idx`` range, with
    ``rep`` the position ``i`` it came from."""
    s, e = indptr[rows], indptr[rows + 1]
    n = e - s
    rep = np.repeat(np.arange(rows.shape[0]), n)
    if not rep.shape[0]:
        return rep, idx[:0]
    first = np.repeat(np.cumsum(n) - n, n)
    return rep, idx[np.repeat(s, n) + np.arange(rep.shape[0]) - first]


def _csr(keys_rows: np.ndarray, values: np.ndarray, n_rows: int):
    """CSR over ``keys_rows`` (sorted) holding ``values``."""
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys_rows, minlength=n_rows), out=indptr[1:])
    return indptr, values


class Graph:
    def __init__(self, raw: snb.RawGraph, dedupe: bool = True):
        self.offsets = raw.offsets
        self.counts = dict(raw.counts)
        self.n_base = raw.n_vertices
        self.v_props = raw.v_props
        self.out: dict[tuple, tuple] = {}
        self.inn: dict[tuple, tuple] = {}
        self.base_keys: dict[tuple, np.ndarray] = {}
        for t, (s, d) in raw.edges.items():
            ns, nd = self.counts[t[0]], self.counts[t[2]]
            so, do = self.offsets[t[0]], self.offsets[t[2]]
            local = s.astype(np.int64) * nd + d
            local = np.unique(local) if dedupe else np.sort(local)
            src, dst = local // nd, local % nd
            self.out[t] = _csr(src, dst + do, ns)
            order = np.lexsort((src, dst))
            self.inn[t] = _csr(dst[order], src[order] + so, nd)
            # pair keys in global ids, sorted: (src, dst) order is kept
            self.base_keys[t] = (src + so) * SHIFT + (dst + do)
        self._ids: dict[tuple, tuple] = {}   # (vtype, prop) -> lookup

    # ------------------------------------------------------------ ranges
    def type_range(self, vtype: str) -> tuple[int, int]:
        o = self.offsets[vtype]
        return o, o + self.counts[vtype]

    def vprop(self, vtype: str, prop: str, ids: np.ndarray) -> np.ndarray:
        """``prop`` of vertices of ``vtype``."""
        return self.v_props[vtype][prop][ids - self.offsets[vtype]]

    def find(self, vtype: str, prop: str, value: int) -> np.ndarray:
        """Ids of the ``vtype`` vertices whose ``prop`` equals ``value``
        (a sorted lookup, built once)."""
        key = (vtype, prop)
        if key not in self._ids:
            vals = self.v_props[vtype][prop]
            o = np.argsort(vals, kind="stable")
            self._ids[key] = (vals[o], o + self.offsets[vtype])
        vals, ids = self._ids[key]
        a = np.searchsorted(vals, value, side="left")
        b = np.searchsorted(vals, value, side="right")
        return ids[a:b]

    # --------------------------------------------------------- adjacency
    def nbrs(self, t: tuple, direction: str, ids: np.ndarray):
        """``(rep, nbr)``: the ``t`` neighbours of each ``ids[i]`` in
        ``direction`` ("out": ids are sources)."""
        ids = np.asarray(ids, dtype=np.int64)
        key_t = t[0] if direction == "out" else t[2]
        lo, hi = self.type_range(key_t)
        csr = self.out[t] if direction == "out" else self.inn[t]
        inside = np.nonzero((ids >= lo) & (ids < hi))[0]
        rep, nbr = gather(csr[0], csr[1], ids[inside] - lo)
        return inside[rep], nbr

    def und(self, t: tuple, ids: np.ndarray):
        """Neighbours over ``t`` in both directions (a pattern edge with
        no arrow): the out list, then the in list."""
        r1, n1 = self.nbrs(t, "out", ids)
        r2, n2 = self.nbrs(t, "in", ids)
        return np.concatenate([r1, r2]), np.concatenate([n1, n2])

    def mult(self, t: tuple, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """How many ``t`` edges go from ``src[i]`` to ``dst[i]``."""
        keys = self.base_keys[t]
        q = src.astype(np.int64) * SHIFT + dst
        return (np.searchsorted(keys, q, side="right")
                - np.searchsorted(keys, q, side="left"))

    def edges(self, t: tuple) -> tuple[np.ndarray, np.ndarray]:
        """The edge list of ``t`` as global ``(src, dst)``."""
        keys = self.base_keys[t]
        return keys // SHIFT, keys % SHIFT

    def out_degree(self, t: tuple) -> np.ndarray:
        """Out-degree of ``t`` over the source type's local ids."""
        return np.diff(self.out[t][0])
