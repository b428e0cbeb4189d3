"""Vectorized engine primitives (numpy host path).

These are the bulk operators of the binding-table engine's host path: every
one is a flat gather / segmented reduction / sorted search over dense arrays —
the same dataflow the torch operator set runs on the card
(``graphdb/torchops.py`` and the ``wcoj_intersect`` kernel).  The ``numpy``
spec (``graphdb/numpy_backend.py``) is built from them: the last rung of the
serving layer's degradation ladder and the tests' host oracle.
"""
from __future__ import annotations

import numpy as np


def expand_csr(indptr: np.ndarray, indices: np.ndarray,
               rows_local: np.ndarray,
               pos: np.ndarray | None = None,
               max_out: int | None = None):
    """Expand each row's vertex (local id into this CSR) to all neighbors.

    Returns (row_index, neighbor_global_id, edge_pos): ``row_index[i]`` is the
    originating binding-table row of output i. ``max_out`` is a *predictive*
    blow-up guard: the count is known from degrees before any gather runs.
    """
    start = indptr[rows_local]
    cnt = indptr[rows_local + 1] - start
    total = int(cnt.sum())
    if max_out is not None and total > max_out:
        raise RuntimeError(f"intermediate blow-up: expansion would produce "
                           f"{total} rows > cap {max_out}")
    row_idx = np.repeat(np.arange(rows_local.shape[0], dtype=np.int64), cnt)
    # flat positions: start[row] + intra-row offset
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    flat = np.repeat(start, cnt) + offs
    nbr = indices[flat]
    epos = pos[flat] if pos is not None else flat
    return row_idx, nbr, epos


def bounded_binary_search(indices: np.ndarray, lo: np.ndarray,
                          hi: np.ndarray, targets: np.ndarray):
    """For each i, find ``targets[i]`` within sorted ``indices[lo[i]:hi[i]]``.

    Returns (found: bool[n], pos: int64[n]) — pos is the flat index into
    ``indices`` where the target sits (undefined when not found). This is the
    membership probe of the worst-case-optimal intersection step; the CUDA
    `wcoj_intersect` kernel is its twin on the card.
    """
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    hi_orig = hi.copy()
    # classic vectorized binary search on per-row bounds
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        v = np.where(active, indices[np.minimum(mid, indices.shape[0] - 1)], 0)
        go_right = active & (v < targets)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    pos = lo
    # a hit must land strictly inside the row's own [lo, hi_orig) range —
    # pos == hi_orig means "not present" (indices[pos] is the next row!)
    in_range = pos < np.minimum(hi_orig, indices.shape[0])
    found = np.zeros(targets.shape, dtype=bool)
    idx = pos[in_range]
    found[in_range] = indices[idx] == targets[in_range]
    return found, pos


def equi_join(lkeys: np.ndarray, rkeys: np.ndarray,
              max_out: int | None = None):
    """All-pairs equi join of two key columns (int64).

    Returns (lidx, ridx): row index pairs with ``lkeys[lidx] == rkeys[ridx]``.
    Sort-merge: O((L+R) log) with fully vectorized pair expansion.
    """
    lorder = np.argsort(lkeys, kind="stable")
    rorder = np.argsort(rkeys, kind="stable")
    ls, rs = lkeys[lorder], rkeys[rorder]
    # for each left row, the matching right range
    lo = np.searchsorted(rs, ls, side="left")
    hi = np.searchsorted(rs, ls, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if max_out is not None and total > max_out:
        raise RuntimeError(f"intermediate blow-up: join would produce "
                           f"{total} rows > cap {max_out}")
    if total == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    lrep = np.repeat(np.arange(ls.shape[0], dtype=np.int64), cnt)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    rpos = np.repeat(lo, cnt) + offs
    return lorder[lrep], rorder[rpos]


def combine_keys(cols: list[np.ndarray]) -> np.ndarray:
    """Pack multiple int64 key columns into one comparable int64 key.
    Uses factorization so values never overflow."""
    if len(cols) == 1:
        return cols[0]
    key = None
    for c in cols:
        _, inv = np.unique(c, return_inverse=True)
        card = int(inv.max()) + 1 if inv.size else 1
        key = inv if key is None else key * card + inv
    return key


def group_reduce(keys: np.ndarray, values: dict[str, tuple[str, np.ndarray]]):
    """Group by packed keys. values: name -> (fn, column). Returns
    (unique_key_first_row_index, {name: aggregated}) where the first element
    indexes a representative row per group (for key column extraction)."""
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    n = uniq.shape[0]
    out = {}
    for name, (fn, col) in values.items():
        if fn == "COUNT":
            out[name] = np.bincount(inv, minlength=n).astype(np.int64)
        elif fn == "SUM":
            out[name] = np.bincount(inv, weights=col, minlength=n).astype(np.int64)
        elif fn == "AVG":
            s = np.bincount(inv, weights=col, minlength=n)
            c = np.bincount(inv, minlength=n)
            out[name] = s / np.maximum(c, 1)
        elif fn == "MIN":
            acc = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(acc, inv, col)
            out[name] = acc
        elif fn == "MAX":
            acc = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
            np.maximum.at(acc, inv, col)
            out[name] = acc
        else:
            raise ValueError(f"unknown aggregate {fn}")
    return first, out
