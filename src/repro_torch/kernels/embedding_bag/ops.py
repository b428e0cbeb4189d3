"""Wrappers of the embedding-bag kernels, forward and backward.

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
``ref.py``.  Where the table requires a gradient it runs through
``EmbeddingBagFn``, whose backward is ``embedding_bag_backward``.  On the
meta device (the dry run) both return empty outputs and report the
kernel's work (``kernels.report_meta``: D adds a slot; the ids, a row a
slot and the output), and run neither a kernel nor the plain version.

``embedding_bag_backward(ids, grad_bags, V)`` is the table's gradient, a
dense fp32 ``[V, D]``: on a CUDA device the deterministic scatter-add of
``csrc/embedding_bag_bwd.cu`` over the slots sorted by row (no fallback),
on the CPU the plain version.

Launch counts (``repro_torch.kernels.LAUNCHES``): ``embedding_bag`` for
every forward launch, and ``embedding_bag.vec`` or ``embedding_bag.warp``
for the route taken; ``embedding_bag_bwd`` for every backward call (its
two kernels, launched back to back).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch, nbytes, report_meta
from repro_torch.kernels.embedding_bag.ref import (
    bag_width, bags_per_row, embedding_bag_backward_ref, embedding_bag_ref)

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
BWD_NAME = "embedding_bag_bwd"
BWD_SOURCE = SOURCE.with_name("embedding_bag_bwd.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 16          # bytes a vec lane loads per row and slot
# sorted slots one warp of the backward sums: a row's slots past one chunk
# are summed as chunk partials, which a second kernel adds in chunk order
BWD_CHUNK = 256


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
    ``out`` is returned.  Differentiable in the table."""
    _check(ids, table, out)
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBagFn.apply(table, ids, out)
    return _embedding_bag(ids, table, out)


def dense_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` where its rows are dense and apart (last stride 1, row stride
    at least a row), as the kernels read a bag gradient; else a contiguous
    copy (autograd may hand a backward an expanded gradient)."""
    if t.stride(-1) == 1 and (t.shape[0] <= 1 or t.stride(0) >= t.shape[1]):
        return t
    return t.contiguous()


class EmbeddingBagFn(torch.autograd.Function):
    """``embedding_bag(ids, table, out)`` with the table's gradient from
    ``embedding_bag_backward`` (fp32, cast to the table's dtype); the ids
    and ``out`` take none.  With ``out`` the result shares its storage."""

    @staticmethod
    def forward(ctx, table, ids, out):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return _embedding_bag(ids, table, out)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        g = embedding_bag_backward(ids, dense_rows(grad.float()), ctx.rows)
        return g.to(ctx.dtype), None, None


def _embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                   out: torch.Tensor | None) -> torch.Tensor:
    """One launch of the forward kernel (or the plain version on the
    CPU)."""
    device = ids.device
    if device.type == "cpu":
        return embedding_bag_ref(ids, table, out=out)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"{NAME}: no kernel for device {device}")
    N, L = ids.shape
    V, D = table.shape
    if out is None:
        result = torch.empty((N, D), dtype=table.dtype, device=device)
        G, row_stride = 1, D
    else:
        result = out
        G, row_stride = bags_per_row(N, D, out), out.stride(0)
    if device.type == "meta":
        report_meta(NAME, N * L * D,
                    nbytes(ids) + (N * L + N) * D * table.element_size(),
                    table.dtype)
        return result
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


def _bwd_fn():
    fn = _build.load(BWD_SOURCE).embedding_bag_bwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # keys, order, grad, out, partial, S, L, V, D, G, row_stride, chunk,
        # stream
        fn.argtypes = [p, p, p, p, p, i64, i, i64, i, i64, i64, i, p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag_backward(ids: torch.Tensor, grad_bags: torch.Tensor,
                           V: int) -> torch.Tensor:
    """The table's gradient of ``embedding_bag(ids, table)`` for a table of
    ``V`` rows, as ``ref.embedding_bag_backward_ref`` defines it: ids
    ``[N, L]`` int32, ``grad_bags`` fp32, a 2-D view whose rows each hold
    ``G`` consecutive bags' gradients (``[N / G, G * D]``, last stride 1,
    any row stride, 4-byte aligned) -> dense fp32 ``[V, D]``.

    On a CUDA device the output is zeroed here (``torch.zeros``: the rows
    no slot names stay 0), the slots' row ids (``V`` for padding and ids
    past the table) sorted stably with ``torch.sort`` (an index
    permutation: each row's slots become one run in slot order), then the
    two kernels of ``csrc/embedding_bag_bwd.cu`` sum each row's run, a warp
    a chunk of ``BWD_CHUNK`` sorted slots and the chunk partials of a row
    longer than a chunk in chunk order: no atomics, so two calls give the
    same bits.  It raises rather than fall back."""
    if not (isinstance(ids, torch.Tensor) and isinstance(grad_bags,
                                                         torch.Tensor)
            and ids.dim() == 2):
        raise ValueError(f"{BWD_NAME}: ids must be a 2-D tensor and "
                         f"grad_bags a tensor")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        raise TypeError(f"{BWD_NAME}: ids must be contiguous int32, got "
                        f"{ids.dtype}")
    if grad_bags.dtype != torch.float32:
        raise TypeError(f"{BWD_NAME}: grad_bags must be float32, got "
                        f"{grad_bags.dtype}")
    if ids.device != grad_bags.device:
        raise ValueError(f"{BWD_NAME}: ids are on {ids.device}, grad_bags "
                         f"on {grad_bags.device}")
    if not 0 <= V < 2**31 - 1:
        raise ValueError(f"{BWD_NAME}: V = {V} is not a row count below "
                         f"2^31 - 1")
    N, L = ids.shape
    D = bag_width(N, grad_bags)
    device = ids.device
    if device.type == "cpu":
        return embedding_bag_backward_ref(ids, grad_bags, V)
    if device.type == "meta":
        out = torch.empty((V, D), dtype=torch.float32, device=device)
        report_meta(BWD_NAME, N * L * D,
                    nbytes(ids, out) + N * D * grad_bags.element_size(),
                    torch.float32)
        return out
    if device.type != "cuda":
        raise ValueError(f"{BWD_NAME}: no kernel for device {device}")
    out = torch.zeros((V, D), dtype=torch.float32, device=device)
    S = N * L
    if S == 0 or V == 0:
        return out
    keys = torch.where((ids >= 0) & (ids < V), ids, V).reshape(-1)
    keys, order = torch.sort(keys, stable=True)
    partial = torch.empty((2 * (-(-S // BWD_CHUNK)), D),
                          dtype=torch.float32, device=device)
    G = bags_per_row(N, D, grad_bags)
    fn = _bwd_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(keys.data_ptr(), order.data_ptr(), grad_bags.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), S, L, V, D, G,
                 grad_bags.stride(0), BWD_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME}: kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(BWD_NAME)
    return out
