"""Plain PyTorch version of the grouped matmul kernel."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor, *,
                       trans_x: bool = False,
                       trans_w: bool = False) -> torch.Tensor:
    """op(x) ``[G, M, K]`` @ op(w) ``[G, K, N]`` -> ``[G, M, N]``,
    accumulated in fp32 and returned in x.dtype; op transposes the last
    two dimensions of x given ``[G, K, M]`` (``trans_x``) and of w given
    ``[G, N, K]`` (``trans_w``)."""
    if trans_x:
        x = x.transpose(1, 2)
    if trans_w:
        w = w.transpose(1, 2)
    return torch.bmm(x.float(), w.float()).to(x.dtype)
