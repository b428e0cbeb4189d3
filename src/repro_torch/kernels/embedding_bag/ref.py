"""Plain PyTorch versions of the embedding-bag kernels: the forward as a
masked ``index_select`` and a sum over the bag's slots, the backward (the
table's gradient) as one ``index_add_`` of every valid slot's bag
gradient.

The wrappers run them for CPU tensors; on the card they are the oracles
the CUDA kernels are held against.  They materialise every slot's row in
fp32, so they are no yardstick of speed.
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


def bag_width(n_bags: int, grad: torch.Tensor) -> int:
    """``D`` of a view holding the gradients of ``n_bags`` bags, ``G``
    consecutive bags a row (``[n_bags / G, G * D]``, as ``bags_per_row``
    checks, which raises on any other view)."""
    if grad.dim() != 2:
        raise ValueError(f"embedding_bag: the bag gradient must be 2-D, got "
                         f"{tuple(grad.shape)}")
    R, C = grad.shape
    dim = C * R // n_bags if n_bags else C
    bags_per_row(n_bags, dim, grad)
    return dim


def embedding_bag_backward_ref(ids: torch.Tensor, grad_bags: torch.Tensor,
                               V: int) -> torch.Tensor:
    """The table's gradient of ``embedding_bag_ref``: ids ``[N, L]``
    (negative: padding), ``grad_bags`` the gradient of the ``N`` bags (a
    view whose rows each hold ``G`` consecutive bags, as ``bag_width``
    checks) -> dense ``[V, D]`` in fp32 (fp64 for an fp64 gradient).  Each
    slot with ``0 <= id < V`` adds its bag's gradient to row ``id``;
    padding and ids ``>= V`` add nothing, as they read nothing in the
    forward.  One ``index_add_`` in slot order: on the CPU a sequential sum
    in that order, on the card atomics in no fixed order.  A row's fp32 sum
    over tens of thousands of slots strays from the exact sum by up to the
    reference's tolerance where its terms cancel, so the card's checks hold
    the kernel to this function on the fp64 gradient."""
    N, L = ids.shape
    D = bag_width(N, grad_bags)
    dtype = torch.promote_types(grad_bags.dtype, torch.float32)
    out = torch.zeros((V, D), dtype=dtype, device=grad_bags.device)
    if N * L == 0 or V == 0:
        return out
    flat = ids.reshape(-1)
    slots = ((flat >= 0) & (flat < V)).nonzero().squeeze(1)
    rows = grad_bags.reshape(N, D).to(dtype).index_select(0, slots // L)
    return out.index_add_(0, flat[slots].to(torch.int64), rows)
