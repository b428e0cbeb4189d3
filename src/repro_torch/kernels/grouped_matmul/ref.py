"""Plain PyTorch version of the grouped matmul kernel."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[G, M, K]`` @ w ``[G, K, N]`` -> ``[G, M, N]``, accumulated in
    fp32 and returned in x.dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)
