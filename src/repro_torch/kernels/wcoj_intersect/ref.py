"""Plain PyTorch version of the WCOJ membership probe: a vectorized
per-row binary search over a sorted CSR (the twin of the reference's
``vecops.bounded_binary_search`` and ``jaxops.bounded_binary_search``).

The wrapper runs it for CPU tensors; on the card it is the oracle the CUDA
kernel is held against, exactly.  It syncs once per search step, so it is
no yardstick of speed.
"""
from __future__ import annotations

import torch


def wcoj_intersect_ref(indptr: torch.Tensor, indices: torch.Tensor,
                       rows: torch.Tensor, targets: torch.Tensor,
                       pos_map: torch.Tensor | None = None):
    """Lower bound of ``targets[i]`` in row ``rows[i]`` of the CSR.

    Returns ``(found bool, epos int32)``: ``epos`` is the edge position
    ``pos_map[slot]`` of the hit's flat slot in ``indices`` (the slot
    itself without a map), 0 when absent."""
    r = rows.to(torch.int64)
    lo = indptr[r].to(torch.int64)
    end = indptr[r + 1].to(torch.int64)
    hi = end.clone()
    n = indices.shape[0]
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = (lo + hi) // 2
        go_right = active & (indices[mid.clamp(max=n - 1)] < targets)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    if n == 0:
        found = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        slot = lo
    else:
        slot = lo.clamp(max=n - 1)
        found = (lo < end) & (indices[slot] == targets)
    mapped = lo if pos_map is None or n == 0 else pos_map[slot]
    epos = torch.where(found, mapped, 0).to(torch.int32)
    return found, epos


def fence_start(lo: torch.Tensor, last: torch.Tensor, node: int = 8):
    """The fence walk's start level of rows ``[lo, last]`` (int64, not
    empty), as the CUDA kernel finds it: the lowest level whose nodes the
    row spans at most two of, from the top bit of ``last - lo`` and one
    shift test.  Returns ``(level, two)``, ``two`` where it reads two
    nodes."""
    shift = node.bit_length() - 1
    d = last - lo
    bits = torch.arange(32, device=d.device)
    top_bit = ((d[:, None] >> bits) > 0).sum(1) - 1    # -1 for d = 0
    level = ((top_bit + shift - 1).div(shift, rounding_mode="floor") - 1
             ).clamp(min=0)
    sh = shift * (level + 1)
    level = level + ((last >> sh) - (lo >> sh) > 1).long()
    sh = shift * (level + 1)
    return level, (last >> sh) != (lo >> sh)


def fence_reads(indptr: torch.Tensor, rows: torch.Tensor,
                node: int = 8) -> int:
    """Sector reads the fence route makes for the probes of ``rows``, at 8
    keys (one 32-byte sector) a node: a walked row reads its start level's
    one or two nodes, then one a level down to the leaves; a row of fewer
    than ``ops.SMALL_ROW`` keys counts the sectors it spans (its binary
    search reads no more); an empty row none.  The final read of the lower
    bound's slot is not counted: it mostly falls in a sector just read."""
    from repro_torch.kernels.wcoj_intersect.ops import SMALL_ROW
    r = rows.to(torch.int64)
    lo = indptr[r].to(torch.int64)
    last = indptr[r + 1].to(torch.int64) - 1
    live = lo <= last
    small = live & (last - lo + 1 < SMALL_ROW)
    walk = live & ~small
    shift = node.bit_length() - 1
    level, two = fence_start(lo[walk], last[walk], node)
    spans = (last[small] >> shift) - (lo[small] >> shift) + 1
    return int((level + 1 + two.to(torch.int64)).sum() + spans.sum())


def fence_walk_ref(indptr: torch.Tensor, indices: torch.Tensor,
                   index: torch.Tensor, rows: torch.Tensor,
                   targets: torch.Tensor,
                   pos_map: torch.Tensor | None = None, node: int = 8,
                   small: int | None = None):
    """Step-by-step model of the CUDA ``fence`` route, vectorized over the
    probes: rows of fewer than ``small`` keys take a binary search over the
    row; the others walk down ``index`` (``ops.build_search_index(indices,
    node)``) with the same start level, the same aligned node reads (keys
    past ``nnz`` lie outside every row; they read as INT32_MAX here), the
    same below-target bit masks cleared outside the row's range and
    counted.  Then the same final read of the lower bound's slot.  Only
    the tests use it; it must equal ``wcoj_intersect_ref`` exactly."""
    from repro_torch.kernels.wcoj_intersect.ops import (INT32_MAX, SMALL_ROW,
                                                        search_levels)
    if small is None:
        small = SMALL_ROW
    shift = node.bit_length() - 1
    nnz = indices.shape[0]
    dev = indptr.device
    offs = torch.tensor([0] + [off for off, _ in search_levels(nnz, node)],
                        device=dev)
    r = rows.to(torch.int64)
    lo = indptr[r].to(torch.int64)
    last = indptr[r + 1].to(torch.int64) - 1
    t = targets.to(torch.int64)
    live = lo <= last
    short = live & (last - lo + 1 < small)
    q = torch.arange(node, device=dev)
    big = torch.tensor(INT32_MAX, dtype=torch.int64, device=dev)

    def below_bits(level, n0):
        # bit q where key q of the node at entry n0 of ``level`` is below t
        slot = n0[:, None] + q[None, :]
        at_leaf = (level == 0)[:, None]
        leaf = (indices[slot.clamp(0, max(nnz - 1, 0))].to(torch.int64)
                if nnz else torch.zeros_like(slot))
        upper = (index[(offs[level.clamp(min=0)][:, None] + slot)
                       .clamp(0, max(index.shape[0] - 1, 0))].to(torch.int64)
                 if index.shape[0] else torch.zeros_like(slot))
        keys = torch.where(at_leaf, leaf, upper)
        keys = torch.where(at_leaf & (slot >= nnz), big, keys)
        return ((keys < t[:, None]).long() << q).sum(1)

    def descend(lt, level, n0):
        sh = shift * level
        head, hi = lo >> sh, last.clamp(min=0) >> sh
        start = torch.maximum(head, n0)
        a = (start + (level > 0).long() - n0).clamp(0, 32)
        z = (hi - n0).clamp(-1, 31)
        in_row = ((0xFFFFFFFF << a) & (0xFFFFFFFF >> (31 - z))) & 0xFFFFFFFF
        return start + _popcount(lt & in_row)

    level, two = fence_start(lo, torch.maximum(last, lo), node)
    sh = shift * level
    n0 = ((lo >> sh) >> shift) << shift
    lt = below_bits(level, n0) | torch.where(
        two, below_bits(level, n0 + node) << node, 0)
    b = descend(lt, level, n0)
    level = torch.where(live & ~short, level - 1, -1)
    while bool((level >= 0).any()):
        act = level >= 0
        k = level.clamp(min=0)
        n0 = b << shift
        b = torch.where(act, descend(below_bits(k, n0), k, n0), b)
        level = torch.where(act, level - 1, level)
    # short rows: a binary search over [lo, last + 1)
    lo_s, hi_s = lo.clone(), last + 1
    while bool((short & (lo_s < hi_s)).any()):
        go = short & (lo_s < hi_s)
        mid = (lo_s + hi_s) >> 1
        below = indices[mid.clamp(0, max(nnz - 1, 0))].to(torch.int64) < t
        lo_s = torch.where(go & below, mid + 1, lo_s)
        hi_s = torch.where(go & ~below, mid, hi_s)
    b = torch.where(short, lo_s, b)
    # b is the lower bound's slot: one read decides membership
    inside = live & (b <= last)
    slot = b.clamp(0, max(nnz - 1, 0))
    key = indices[slot].to(torch.int64) if nnz else torch.zeros_like(b)
    found = inside & (key == t)
    mapped = b if pos_map is None or nnz == 0 else pos_map[slot].to(
        torch.int64)
    epos = torch.where(found, mapped, 0).to(torch.int32)
    return found, epos


def _popcount(x: torch.Tensor) -> torch.Tensor:
    c = torch.zeros_like(x)
    for bit in range(32):
        c = c + ((x >> bit) & 1)
    return c
