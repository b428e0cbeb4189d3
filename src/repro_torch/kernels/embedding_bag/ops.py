"""Wrapper of the embedding-bag kernels.

``embedding_bag(ids, table, out=None)`` sums ``table`` rows over each bag
of ``ids`` (int32 ``[N, L]``, negative ids are padding) into ``[N, D]`` in
the table's dtype, accumulating in fp32; with ``out`` it writes the bags
into that strided view instead.  On a CUDA device it launches one of the
two kernels in ``csrc/embedding_bag.cu`` (built with nvcc at first use) on
the current stream, or raises; it never falls back.  ``route`` picks the
kernel before the launch, from dtype, shape, stride and alignment alone:
``"vec"`` (16-byte row pieces, a lane group a bag, streamed ids and output)
where every row and output row is whole 16-byte pieces, ``"warp"`` (a warp
a bag, element loads) for the rest.  On the CPU it runs the plain version in
``ref.py``.

Launch counts (``repro_torch.kernels.LAUNCHES``): ``embedding_bag`` for
every launch, and ``embedding_bag.vec`` or ``embedding_bag.warp`` for the
route taken.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.embedding_bag.ref import (bags_per_row,
                                                   embedding_bag_ref)

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 16          # bytes a vec lane loads per row and slot


def _kernel_fn(which: str):
    fn = getattr(_build.load(SOURCE), f"{NAME}_{which}")
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # ids, table, out, N, L, V, D, G, row_stride, dtype, stream
        fn.argtypes = [p, p, p, i64, i, i64, i, i64, i64, i, p]
        fn.restype = ctypes.c_int
    return fn


def route(ids: torch.Tensor, table: torch.Tensor,
          out: torch.Tensor | None = None) -> str:
    """``"vec"`` where a row is a whole number of 16-byte pieces, the
    table's base is 16-byte aligned and, given ``out``, so are its base and
    its row stride; ``"warp"`` otherwise.  A fresh output (``out=None``) is
    aligned.  Reads only dtype, shape, stride and ``data_ptr``, so it
    decides on any device."""
    esize = table.element_size()
    if table.shape[1] * esize % PIECE or table.data_ptr() % PIECE:
        return "warp"
    if out is not None and (out.data_ptr() % PIECE
                            or out.stride(0) * esize % PIECE):
        return "warp"
    return "vec"


def _check(ids, table, out):
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
    if out is None:
        return
    if not isinstance(out, torch.Tensor) or out.dtype != table.dtype:
        raise TypeError(f"{NAME}: out must be a {table.dtype} tensor")
    if out.device != table.device:
        raise ValueError(f"{NAME}: out is on {out.device}, table on "
                         f"{table.device}")
    bags_per_row(ids.shape[0], table.shape[1], out)


def embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """ids ``[N, L]`` int32 @ table ``[V, D]`` -> ``[N, D]``, as
    ``ref.embedding_bag_ref`` defines it.  ``out``: a 2-D view in the
    table's dtype whose rows each hold ``G`` consecutive bags (``[N / G,
    G * D]``, last stride 1, any row stride); the bags are written there and
    ``out`` is returned."""
    _check(ids, table, out)
    device = ids.device
    if device.type == "cpu":
        return embedding_bag_ref(ids, table, out=out)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    N, L = ids.shape
    V, D = table.shape
    if out is None:
        result = torch.empty((N, D), dtype=table.dtype, device=device)
        G, row_stride = 1, D
    else:
        result = out
        G, row_stride = bags_per_row(N, D, out), out.stride(0)
    if N == 0 or D == 0:
        return result
    if L == 0:
        return result.zero_()
    which = route(ids, table, out)
    fn = _kernel_fn(which)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(), table.data_ptr(), result.data_ptr(), N, L,
                 V, D, G, row_stride, _DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: {which} kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    count_launch(f"{NAME}.{which}")
    return result
