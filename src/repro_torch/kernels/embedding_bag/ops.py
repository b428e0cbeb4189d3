"""Wrapper of the embedding-bag kernel.

``embedding_bag(ids, table)`` sums ``table`` rows over each bag of ``ids``
(int32 ``[B, L]``, negative ids are padding) into ``[B, D]`` in the table's
dtype, accumulating in fp32.  On a CUDA device it launches the kernel in
``csrc/embedding_bag.cu`` (built with nvcc at first use) on the current
stream, or raises; it never falls back.  On the CPU it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bag_fn():
    fn = _build.load(SOURCE).embedding_bag
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, i64, i, i64, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids ``[B, L]`` int32 @ table ``[V, D]`` -> ``[B, D]``, as
    ``ref.embedding_bag_ref`` defines it."""
    if not (isinstance(ids, torch.Tensor) and isinstance(table, torch.Tensor)
            and ids.dim() == 2 and table.dim() == 2):
        raise ValueError(f"{NAME}: ids and table must be 2-D tensors")
    if ids.dtype != torch.int32:
        raise TypeError(f"{NAME}: ids must be int32, got {ids.dtype}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{NAME}: ids and table must be contiguous")
    if ids.device != table.device:
        raise ValueError(f"{NAME}: ids are on {ids.device}, table on "
                         f"{table.device}")
    device = ids.device
    if device.type == "cpu":
        return embedding_bag_ref(ids, table)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    B, L = ids.shape
    V, D = table.shape
    if B == 0 or L == 0 or D == 0:
        return torch.zeros((B, D), dtype=table.dtype, device=device)
    out = torch.empty((B, D), dtype=table.dtype, device=device)
    fn = _bag_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), B, L, V,
                 D, _DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(NAME)
    return out
