"""Plain PyTorch version of the embedding-bag kernel: a masked
``index_select`` and a sum over the bag's slots.

The wrapper runs it for CPU tensors; on the card it is the oracle the CUDA
kernel is held against.  It materialises every slot's row in fp32, so it
is no yardstick of speed.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids ``[B, L]`` (negative: padding), table ``[V, D]`` -> ``[B, D]`` in
    the table's dtype: the fp32 sum of ``table[id]`` over the slots with
    ``0 <= id < V``.  An id ``>= V`` contributes nothing, as in the Pallas
    kernel (which matches no tile for it)."""
    B, L = ids.shape
    V, D = table.shape
    if B * L == 0 or V == 0:
        return torch.zeros((B, D), dtype=table.dtype, device=table.device)
    valid = (ids >= 0) & (ids < V)
    rows = torch.where(valid, ids, 0).to(torch.int64).reshape(-1)
    emb = table.index_select(0, rows).reshape(B, L, D).float()
    emb.masked_fill_(~valid[..., None], 0.0)
    return emb.sum(dim=1).to(table.dtype)
