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
