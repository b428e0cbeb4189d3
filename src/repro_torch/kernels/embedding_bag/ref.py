"""Plain PyTorch version of the embedding-bag kernel: a masked
``index_select`` and a sum over the bag's slots.

The wrapper runs it for CPU tensors; on the card it is the oracle the CUDA
kernels are held against.  It materialises every slot's row in fp32, so it
is no yardstick of speed.
"""
from __future__ import annotations

import torch


def bags_per_row(n_bags: int, dim: int, out: torch.Tensor) -> int:
    """``G``, the bags each row of ``out`` holds: ``out`` is a 2-D view
    ``[n_bags / G, G * dim]`` with last stride 1 and rows that do not
    overlap.  Raises ``ValueError`` on any other view."""
    if out.dim() != 2:
        raise ValueError(f"embedding_bag: out must be 2-D, got "
                         f"{tuple(out.shape)}")
    R, C = out.shape
    if dim == 0 or C % dim or R * (C // dim) != n_bags or (
            n_bags and C == 0):
        raise ValueError(f"embedding_bag: out {tuple(out.shape)} does not "
                         f"hold {n_bags} bags of {dim} values a row at a "
                         f"time")
    if out.numel() and (out.stride(1) != 1
                        or (R > 1 and out.stride(0) < C)):
        raise ValueError(f"embedding_bag: out's rows must be dense and "
                         f"apart, got strides {out.stride()}")
    return C // dim if C else 1


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """ids ``[N, L]`` (negative: padding), table ``[V, D]`` -> ``[N, D]`` in
    the table's dtype: the fp32 sum of ``table[id]`` over the slots with
    ``0 <= id < V``.  An id ``>= V`` contributes nothing, as in the Pallas
    kernel (which matches no tile for it).  With ``out`` (a view whose rows
    each hold ``G`` consecutive bags, as ``bags_per_row`` checks) the bags
    are written there, nothing else of its storage is touched, and ``out``
    is returned."""
    N, L = ids.shape
    V, D = table.shape
    if N * L == 0 or V == 0:
        bags = torch.zeros((N, D), dtype=table.dtype, device=table.device)
    else:
        valid = (ids >= 0) & (ids < V)
        rows = torch.where(valid, ids, 0).to(torch.int64).reshape(-1)
        emb = table.index_select(0, rows).reshape(N, L, D).float()
        emb.masked_fill_(~valid[..., None], 0.0)
        bags = emb.sum(dim=1).to(table.dtype)
    if out is None:
        return bags
    bags_per_row(N, D, out)
    return out.copy_(bags.reshape(out.shape))
