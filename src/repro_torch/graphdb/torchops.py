"""Eager PyTorch twins of the reference's jit'd engine primitives.

The compound steps of the binding-table engine — CSR expansion, sort-merge
join, lexicographic key packing and sorted-run grouping — written as eager
tensor code that runs on whatever device its inputs live on.  They mirror
``repro/graphdb/jaxops.py`` (``range_flatten`` .. ``sortmerge_pairs``) but
need no static shapes: eager PyTorch has no trace cache to stabilise, so
nothing is padded to pow2 buckets, and data-dependent output sizes are
read back as scalars (control-plane syncs) right where they are needed.

Id and position columns are int32; PyTorch's sorts, cumulative sums and
searches return int64, which every function here narrows back on purpose.
Sums accumulate in int64 and averages in float64 on the device, so the
aggregates equal the host numpy backend's exactly.
"""
from __future__ import annotations

import torch

_I32 = torch.int32
_I64 = torch.int64


def stable_argsort(x: torch.Tensor) -> torch.Tensor:
    """Ascending stable sort order (int64), ties in original row order."""
    return torch.sort(x, stable=True).indices


def lexsort(cols: list) -> torch.Tensor:
    """``np.lexsort`` twin: the LAST column is the primary key, ties keep
    original row order.  Built from successive stable sorts, least
    significant key first (PyTorch has no lexsort)."""
    order = stable_argsort(cols[0])
    for c in cols[1:]:
        order = order[stable_argsort(c[order])]
    return order


def range_flatten(start: torch.Tensor, counts: torch.Tensor, total: int):
    """Row-major flattening of per-row ranges ``[start_i, start_i +
    counts_i)``: returns ``(row_idx[total], flat_pos[total])`` (int64).
    ``total`` is ``counts.sum()``, already synced by the caller, so
    ``repeat_interleave`` never syncs again."""
    counts = counts.to(_I64)
    n = counts.shape[0]
    ridx = torch.repeat_interleave(
        torch.arange(n, device=counts.device), counts, output_size=total)
    excl = torch.cumsum(counts, 0) - counts
    offs = (torch.arange(total, device=counts.device)
            - torch.repeat_interleave(excl, counts, output_size=total))
    return ridx, start.to(_I64)[ridx] + offs


def csr_degrees(indptr: torch.Tensor, rows: torch.Tensor):
    """(start, degree) of each row, int64."""
    rows = rows.to(_I64)
    start = indptr[rows].to(_I64)
    return start, indptr[rows + 1].to(_I64) - start


def csr_expand_total(indptr: torch.Tensor, rows: torch.Tensor) -> int:
    """Exact output size of a CSR expansion (int64 sum, one sync) — the
    blow-up guard reads it before anything is allocated."""
    return int(csr_degrees(indptr, rows)[1].sum())


def csr_expand_flat(indptr, indices, pos, rows, total: int):
    """CSR expansion of ``rows`` into exactly ``total`` row-major outputs:
    ``(row_idx, neighbor, edge_pos)`` as int32.  ``pos`` maps a flat CSR
    slot to its edge identity (None: the slot is the identity)."""
    start, deg = csr_degrees(indptr, rows)
    ridx, flat = range_flatten(start, deg, total)
    nbr = indices[flat]
    epos = pos[flat] if pos is not None else flat
    return ridx.to(_I32), nbr.to(_I32), epos.to(_I32)


def lex_ranks(cols: list) -> torch.Tensor:
    """Dense lexicographic ranks of row tuples (``cols[0]`` most
    significant): equal tuples share a rank and rank order is the tuples'
    sort order — the same grouping and ascending order as the numpy
    backend's factorized packing, so row order stays identical."""
    n = cols[0].shape[0]
    order = lexsort(list(reversed(cols)))
    ne = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=cols[0].device)
    for c in cols:
        s = c[order]
        ne |= s[1:] != s[:-1]
    gid_sorted = torch.cat([torch.zeros(1, dtype=_I64, device=ne.device),
                            torch.cumsum(ne.to(_I64), 0)])
    ranks = torch.empty(n, dtype=_I32, device=ne.device)
    ranks[order] = gid_sorted.to(_I32)
    return ranks


def group_boundaries(keys: torch.Tensor):
    """Stage 1 of sorted-run grouping: stable sort by key and find the run
    starts.  Returns ``(order, starts)`` (int64); the number of groups is
    ``starts.shape[0]`` (one sync, inside ``nonzero``)."""
    order = stable_argsort(keys)
    sk = keys[order]
    flags = torch.ones(sk.shape[0], dtype=torch.bool, device=sk.device)
    flags[1:] = sk[1:] != sk[:-1]
    return order, torch.nonzero(flags).flatten()


def group_aggregate(order: torch.Tensor, starts: torch.Tensor,
                    cols: tuple, fns: tuple):
    """Stage 2: every aggregate over the sorted runs.  ``first`` is each
    group's minimal original row (the sort is stable).  COUNT and SUM come
    out int64, AVG float64 (the exact int64 sum over the count, as numpy's
    float64 bincount gives for integer columns), MIN/MAX in the column's
    dtype."""
    n = order.shape[0]
    ng = starts.shape[0]
    bounds = torch.cat([starts, torch.full((1,), n, dtype=_I64,
                                           device=starts.device)])
    counts = bounds[1:] - bounds[:-1]
    first = order[starts]
    # group id of every sorted row, for the scatter reductions
    gid = torch.repeat_interleave(torch.arange(ng, device=starts.device),
                                  counts, output_size=n)
    outs = []
    for fn, col in zip(fns, cols):
        if fn == "COUNT":
            outs.append(counts)
            continue
        sc = col[order]
        if fn in ("SUM", "AVG"):
            acc = torch.float64 if sc.is_floating_point() else _I64
            cs = torch.cat([torch.zeros(1, dtype=acc, device=sc.device),
                            torch.cumsum(sc.to(acc), 0)])
            sums = cs[bounds[1:]] - cs[bounds[:-1]]
            if fn == "SUM":
                outs.append(sums.to(_I64))
            else:
                outs.append(sums.to(torch.float64)
                            / counts.clamp(min=1).to(torch.float64))
            continue
        red = "amin" if fn == "MIN" else "amax"
        out = torch.empty(ng, dtype=sc.dtype, device=sc.device)
        outs.append(out.scatter_reduce_(0, gid, sc, red, include_self=False))
    return first, tuple(outs)


def sortmerge_bounds(lkeys: torch.Tensor, rkeys: torch.Tensor):
    """Stage 1 of the sort-merge join: stable sorts and, per left row in
    sorted order, its matching right range.  Returns ``(lorder, rorder,
    lo, cnt)`` (int64)."""
    lorder = stable_argsort(lkeys)
    rorder = stable_argsort(rkeys)
    ls = lkeys[lorder]
    rs = rkeys[rorder]
    if ls.dtype != rs.dtype:
        dt = torch.promote_types(ls.dtype, rs.dtype)
        ls, rs = ls.to(dt), rs.to(dt)
    lo = torch.searchsorted(rs, ls, right=False)
    cnt = torch.searchsorted(rs, ls, right=True) - lo
    return lorder, rorder, lo, cnt


def sortmerge_pairs(lorder, rorder, lo, cnt, total: int):
    """Pair expansion of the sort-merge join: ``(lidx, ridx)`` int32, in
    sort-merge order (by left sorted position, then right)."""
    lrep, rpos = range_flatten(lo, cnt, total)
    return lorder[lrep].to(_I32), rorder[rpos].to(_I32)
