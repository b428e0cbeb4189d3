"""Eager PyTorch twins of the reference's jit'd engine primitives.

The compound steps of the binding-table engine — CSR expansion, sort-merge
join, lexicographic key packing and sorted-run grouping — written as eager
tensor code that runs on whatever device its inputs live on.  They mirror
``repro/graphdb/jaxops.py`` (``range_flatten`` .. ``sortmerge_pairs``) but
need no static shapes: eager PyTorch has no trace cache to stabilise, so
nothing is padded to pow2 buckets, and data-dependent output sizes are
read back as scalars (control-plane syncs) right where they are needed.
The fused chain program (``build_fused_chain``) is the exception: it
keeps the reference's pow2 capacities, so a whole chain runs with one
sync at its end.

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


def expand_padded(indptr: torch.Tensor, indices: torch.Tensor,
                  rows: torch.Tensor, d_max: int):
    """Each row's first ``d_max`` neighbours as a padded block, the twin of
    the reference's ``jaxops.expand_padded``: ``(nbr, valid, flat)``, each
    ``[R, d_max]``; ``nbr`` and ``flat`` (the slot in ``indices``) are -1
    where ``valid`` is False.  A row of more than ``d_max`` neighbours is
    cut (the caller sizes ``d_max``); ``indices`` is not empty.  Only the
    host-staging baseline (``host_staging.py``) expands this way."""
    rows = rows.to(_I64)
    start = indptr[rows]
    deg = indptr[rows + 1] - start
    offs = torch.arange(d_max, dtype=indptr.dtype,
                        device=indptr.device)[None, :]
    valid = offs < deg[:, None]
    flat = torch.clamp(start[:, None] + offs, 0, indices.shape[0] - 1)
    nbr = torch.where(valid, indices[flat.to(_I64)], -1)
    return nbr, valid, torch.where(valid, flat, -1)


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


# ---------------------------------------------------------- fused chains
#
# One whole ExpandChainNode as one eager program over pow2-padded buffers,
# the twin of ``jaxops.build_fused_chain``: row-major flattening, neighbour
# and edge gathers, the trailing WCOJ membership probes (each one launch of
# the ``wcoj_intersect`` kernel on the card) and the folded predicate masks
# run with no host sync in between.  Each hop writes into a static capacity
# (``caps[k]``); rows past a hop's true total are dead slots carried by a
# validity mask, and filtered rows contribute zero degree to the next hop,
# so emission order is the per-hop loop's orientation-major, row-major
# order.  The program returns the padded columns, the stable order that
# brings the valid rows to the front, their count and the per-hop totals;
# the caller reads the counts in one sync.

_CHAIN_CMP = {"=": lambda a, b: a == b, "<>": lambda a, b: a != b,
              "<": lambda a, b: a < b, ">": lambda a, b: a > b,
              "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}

_CHAIN_I32_MIN = -2147483648


def take_clip(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(a, idx, mode="clip")``: indices clamped into ``a``'s
    range; an empty ``a`` gives zeros (every such read is a dead slot)."""
    n = a.shape[0]
    if n == 0:
        return torch.zeros(idx.shape, dtype=a.dtype, device=idx.device)
    return a[idx.clamp(0, n - 1)]


def sorted_isin(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``torch.isin(x, s)`` for a non-empty ascending ``s``, with no host
    sync: each ``x`` is looked up with ``searchsorted`` and compared with
    the value found there.  ``torch.isin`` on CUDA sorts through ``_unique``
    once ``s`` outgrows a size heuristic, and that syncs, so a captured
    program cannot use it."""
    dt = torch.promote_types(x.dtype, s.dtype)
    x, s = x.to(dt), s.to(dt)
    i = torch.searchsorted(s, x).clamp(max=s.shape[0] - 1)
    return s[i] == x


def build_fused_chain(desc: tuple, caps: tuple, in_bucket: int, probe,
                      empty_values: tuple = ()):
    """The whole-chain function of one static chain shape.

    ``desc`` = ``(source_col, hops)``; each hop is ``(from_col, alias,
    edge_alias, orients, probes, pred)`` with orients ``(lo, hi, tidx,
    has_pos)``, probes ``(from_col, edge_alias, lo, hi, vlo, vhi, tidx,
    has_pos)`` and ``pred`` a resolved predicate signature whose column
    refs are ``("col", name) | ("vprop", name, idx) | ("eprop",
    edge_alias, idx)`` and whose leaves read runtime slots.  ``probe`` is
    the membership probe, ``wcoj_intersect``'s signature (the backend
    passes the kernel's wrapper; the reference picked padded-ELL tiles or
    a binary search by degree, the kernel searches the CSR at any
    degree).  ``csrs[k]`` holds each hop's ``(indptr, indices, pos,
    index)`` per orientation and per probe; a probe's ``index`` is the
    CSR's search index.

    The program reads no run value on the host: ``n0``, the source count,
    may be a Python int or a device scalar, and each IN-set arrives sorted
    ascending (padded to any length by repeating one of its values), so
    membership is ``sorted_isin``.  It has no host sync at all and can be
    captured as a CUDA graph."""
    source_col, hops = desc

    def eval_ref(ref, cols, vprops, eprops):
        if ref[0] == "col":
            return cols[ref[1]]
        if ref[0] == "vprop":
            _, name, pidx = ref
            return take_clip(vprops[pidx], cols[name].to(_I64))
        _, ealias, pidx = ref
        offsets, flat = eprops[pidx]
        pos = cols[f"{ealias}#p"]
        if flat.shape[0] == 0:
            return torch.full(pos.shape, _CHAIN_I32_MIN, dtype=_I32,
                              device=pos.device)
        base = take_clip(offsets, cols[f"{ealias}#t"].to(_I64))
        return take_clip(flat, base.to(_I64) + pos.to(_I64))

    def eval_pred(sig, cols, scalars, values, vprops, eprops):
        kind = sig[0]
        if kind == "cmp":
            _, op, ref, slot = sig
            return _CHAIN_CMP[op](eval_ref(ref, cols, vprops, eprops),
                                  scalars[slot])
        if kind == "in":
            _, ref, vidx = sig
            lhs = eval_ref(ref, cols, vprops, eprops)
            if vidx in empty_values:     # static: empty IN-set matches nothing
                return torch.zeros(lhs.shape, dtype=torch.bool,
                                   device=lhs.device)
            return sorted_isin(lhs, values[vidx])
        if kind == "not":
            return ~eval_pred(sig[1][0], cols, scalars, values, vprops,
                              eprops)
        acc = eval_pred(sig[1][0], cols, scalars, values, vprops, eprops)
        for s in sig[1][1:]:
            m = eval_pred(s, cols, scalars, values, vprops, eprops)
            acc = (acc & m) if kind == "and" else (acc | m)
        return acc

    def run(src, n0, csrs, vprops, eprops, scalars, values):
        dev = src.device
        cols = {"__rows": torch.arange(in_bucket, dtype=_I32, device=dev),
                source_col: src}
        valid = torch.arange(in_bucket, device=dev) < n0
        needed = []
        for k, (from_col, alias, ealias, orients, probes, pred) in \
                enumerate(hops):
            cap = caps[k]
            frm = cols[from_col].to(_I64)
            degs, row_starts = [], []
            for j, (lo, hi, tidx, has_pos) in enumerate(orients):
                indptr = csrs[k][0][j][0]
                local = (frm - lo).clamp(0, max(indptr.shape[0] - 2, 0))
                s0 = take_clip(indptr, local).to(_I64)
                d = take_clip(indptr, local + 1).to(_I64) - s0
                # the keyed-type range membership mask: rows of a
                # mixed-type frontier outside [lo, hi) expand to nothing,
                # exactly like the per-hop loop's nonzero() subset
                in_range = valid & (frm >= lo) & (frm < hi)
                degs.append(torch.where(in_range, d, 0))
                row_starts.append(s0)
            # exact int64 totals (the reference sums in int32 and guards
            # with a float32 twin; the caller applies the same guard)
            totals, offs = [], []
            running = torch.zeros((), dtype=_I64, device=dev)
            for d in degs:
                offs.append(running)
                totals.append(d.sum())
                running = running + totals[-1]
            needed.append(running)
            pos_out = torch.arange(cap, dtype=_I64, device=dev)
            acc_r = torch.zeros(cap, dtype=_I64, device=dev)
            acc_nbr = torch.zeros(cap, dtype=_I32, device=dev)
            acc_tv = torch.zeros(cap, dtype=_I32, device=dev)
            acc_p = torch.zeros(cap, dtype=_I32, device=dev)
            for j, (lo, hi, tidx, has_pos) in enumerate(orients):
                _, indices, pos, _ = csrs[k][0][j]
                in_j = (pos_out >= offs[j]) & (pos_out < offs[j] + totals[j])
                lp = pos_out - offs[j]
                cum = torch.cumsum(degs[j], 0)
                r = torch.searchsorted(cum, lp, right=True)
                excl = take_clip(cum - degs[j], r)
                flat = take_clip(row_starts[j], r) + (lp - excl)
                nb = take_clip(indices, flat)
                ep = take_clip(pos, flat) if has_pos else flat.to(_I32)
                acc_r = torch.where(in_j, r, acc_r)
                acc_nbr = torch.where(in_j, nb, acc_nbr)
                acc_tv = torch.where(in_j, tidx, acc_tv)
                acc_p = torch.where(in_j, ep, acc_p)
            cols = {nm: take_clip(c, acc_r) for nm, c in cols.items()}
            cols[alias] = acc_nbr
            cols[f"{ealias}#t"] = acc_tv
            cols[f"{ealias}#p"] = acc_p
            valid = pos_out < torch.clamp(running, max=cap)
            for pj, (p_from, p_ealias, lo, hi, vlo, vhi, tidx,
                     has_pos) in enumerate(probes):
                indptr, indices, pos, index = csrs[k][1][pj]
                pfrm = cols[p_from]
                n_rows = indptr.shape[0] - 1
                local = (pfrm - lo).clamp(0, max(n_rows - 1, 0))
                # rows outside the keyed/value type ranges fail the probe
                # (the per-hop loop's membership masks); -2 never matches
                # a real id (>= 0)
                ok = (valid & (pfrm >= lo) & (pfrm < hi)
                      & (cols[alias] >= vlo) & (cols[alias] < vhi))
                tgt = torch.where(ok, cols[alias], -2).to(_I32)
                if n_rows > 0:
                    found, ep = probe(indptr, indices,
                                      local.to(_I32).contiguous(),
                                      tgt.contiguous(),
                                      pos if has_pos else None, index)
                else:                   # a keyed type with no vertices
                    found = torch.zeros(cap, dtype=torch.bool, device=dev)
                    ep = torch.zeros(cap, dtype=_I32, device=dev)
                cols[f"{p_ealias}#t"] = torch.full((cap,), tidx, dtype=_I32,
                                                   device=dev)
                cols[f"{p_ealias}#p"] = ep     # 0 where nothing was found
                valid = valid & found
            if pred is not None:
                valid = valid & eval_pred(pred, cols, scalars, values,
                                          vprops, eprops)
        # stable: valid rows first, each group in emission order
        order = torch.sort((~valid).to(torch.uint8), stable=True).indices
        return cols, order, valid.sum(), torch.stack(needed)

    return run
