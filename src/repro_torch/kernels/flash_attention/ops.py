"""Wrapper of the FlashAttention forward kernels.

``flash_attention(q, k, v, q_start, kv_len, window=None, softcap=None)``
takes the model's layout (``ref.flash_attention_ref`` defines the
function).  On a CUDA device it launches one of the three routes in
``csrc/flash_attention.cu`` (built with nvcc at first use) on the current
stream, or raises; it never falls back.  ``route`` picks it before the
launch, from dtype, shape and alignment alone: ``"split"`` (flash-decoding
over 256-key chunks of the cache, then a log-sum-exp merge) for at most 8
query rows per kv head, ``"tc"`` (TMA and wgmma tiles) for bf16 prefill,
``"rows"`` (fp32 FMA tiles: warp-owned query rows, 16-byte shared-memory
reads, cp.async key stages) for the rest.  On the CPU it runs the plain
version in ``ref.py``.  On the meta device (the dry run) it returns empty
outputs and reports the kernel's work (``kernels.report_meta``: 4 hd
flops an admissible pair, ``ref.admissible_pairs``; q, k, v read and the
output written once), and runs neither a kernel nor the plain version.

Launch counts (``repro_torch.kernels.LAUNCHES``): ``flash_attention`` for
every call, and ``flash_attention.tc``, ``.split`` or ``.rows`` for the
route taken (one count per call, though ``split`` runs two kernels).

Under autograd (grad enabled and q, k or v requiring it) the call goes
through ``FlashAttentionFn``: the forward is the call above, and where
``saves_lse`` holds (fp32 on the ``rows`` route: the training path) it also
keeps each row's log-sum-exp, saved with the output for the backward.  The
backward is ``flash_attention_bwd``, which launches the kernels of one of
three routes on a CUDA device, or raises; ``bwd_route`` names the route a
call's operands take, from dtype, shape and alignment alone: ``"tc"`` for
the bf16 operands the forward's ``tc`` route takes
(``csrc/flash_attention_bwd_tc.cu``: TMA and wgmma, bf16 in and out, fp32
sums; each row's log-sum-exp and D = rowsum(P dP) formed first, then dq,
then dk and dv); otherwise the fp32 kernels of
``csrc/flash_attention_bwd.cu`` (bf16 operands cast), on the ``saved``
route where the forward's output and log-sum-exp are given (D from the
output, then dq, then dk and dv) and the ``recompute`` route where they
are not (the log-sum-exp, output and D rows recomputed first).  It counts
once as ``flash_attention_bwd`` and once as ``flash_attention_bwd.tc``,
``.saved`` or ``.recompute``.  On the CPU it runs the plain version
(``ref.flash_attention_bwd_ref``: the closed form the kernels compute when
given the output and log-sum-exp, else autograd through the plain
forward, which is what ``FlashAttentionFn`` takes there).  On the meta
device it reports 10 hd flops an admissible pair (the scores again, dP,
dq, dk and dv) and returns empty gradients.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch, nbytes, report_meta
from repro_torch.kernels.flash_attention.ref import (
    admissible_pairs, flash_attention_bwd_ref, flash_attention_ref,
    per_batch)

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_NAME = "flash_attention_bwd"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
BWD_TC_SOURCE = SOURCE.with_name("flash_attention_bwd_tc.cu")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NO_WINDOW = 1 << 30
SPLIT_ROWS = 8      # query rows per kv head the split route takes
SPLIT_KEYS = 256    # keys per split chunk (kSplitKeys in the source)
TC_ROWS = 128       # query rows per tc block; G must divide it
TC_HEAD_DIMS = (64, 128)


def _kernel_fn(which: str):
    fn = getattr(_build.load(SOURCE), f"flash_attention_{which}")
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, q_start, kv_len, out, then B, Sq, Skv, Kh, G, hd,
        # window, softcap; split also takes three scratch pointers after
        # out, and a dtype and n_split; rows a dtype
        if which == "split":
            fn.argtypes = [p] * 9 + [i] * 7 + [f, i, i, p]
        elif which == "rows":   # and the log-sum-exp pointer after out
            fn.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
        else:
            fn.argtypes = [p] * 6 + [i] * 7 + [f, p]
        fn.restype = ctypes.c_int
    return fn


def _tc_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """bf16 with head_dim 64 or 128, G dividing ``TC_ROWS`` and 16-byte
    aligned bases: what TMA and the wgmma tiles take."""
    G, hd = q.shape[3:]
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and hd in TC_HEAD_DIMS and TC_ROWS % G == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"split"`` for at most ``SPLIT_ROWS`` query rows per kv head
    (``Sq * G``: every decode tick) with head_dim a multiple of 32;
    ``"tc"`` for bf16 with head_dim 64 or 128, G dividing ``TC_ROWS`` and
    16-byte aligned bases (TMA's addressing); ``"rows"`` otherwise (fp32
    prefill, head_dim 16 or 32).  Reads only dtype, shape and
    ``data_ptr``, so it decides on any device."""
    _, Sq, _, G, hd = q.shape
    if Sq * G <= SPLIT_ROWS and hd % 32 == 0:
        return "split"
    if _tc_operands(q, k, v):
        return "tc"
    return "rows"


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward's route for these operands: ``"tc"`` for the bf16
    operands the forward's ``tc`` route takes (any Sq); ``"saved"`` for
    fp32 on the forward's ``rows`` route, which keeps the output's
    log-sum-exp under autograd (the training path); ``"recompute"``
    otherwise (bf16 at head_dim 16 or 32, G not dividing 128, unaligned
    bases; fp32 decode rows).  A direct ``flash_attention_bwd`` call off
    the ``tc`` route takes ``saved`` only when given the output and
    log-sum-exp.  Reads only dtype, shape and ``data_ptr``, so it decides
    on any device."""
    if _tc_operands(q, k, v):
        return "tc"
    if q.dtype == torch.float32 and route(q, k, v) == "rows":
        return "saved"
    return "recompute"


def saves_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``FlashAttentionFn`` keeps each row's log-sum-exp for the
    backward kernel's ``saved`` route: where ``bwd_route`` says ``saved``
    on a CUDA device (fp32 on the ``rows`` route: the training path).
    bf16 keeps none: its rounded output would give D = rowsum(dout * o) an
    error that dq = P (dP - D) k does not cancel, so its ``tc`` backward
    forms D from P and dP itself.  The CPU keeps none either: its backward
    is autograd through the plain forward, which needs no statistics."""
    return q.device.type == "cuda" and bwd_route(q, k, v) == "saved"


def _check(q, k, v):
    for name, t, dim in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if not isinstance(t, torch.Tensor) or t.dim() != dim:
            raise ValueError(f"{NAME}: {name} must be a {dim}-D tensor")
    B, _, Kh, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (Kh, hd):
        raise ValueError(f"{NAME}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{NAME}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{NAME}: q, k and v are on {q.device}, "
                         f"{k.device}, {v.device}")


def _check_options(window, softcap):
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{NAME}: softcap must be > 0, got {softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_start, kv_len, *, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q ``[B, Sq, Kh, G, hd]``; k, v ``[B, Skv, Kh, hd]`` (a cache, read in
    place); ``q_start``, ``kv_len`` ints or ``[B]`` int tensors.  Returns
    ``[B, Sq, Kh, G, hd]`` in q.dtype, differentiable in q, k and v."""
    _check(q, k, v)
    _check_options(window, softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, q_start, kv_len, window,
                                      softcap)
    return _forward(q, k, v, q_start, kv_len, window, softcap)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start, kv_len, *, window: int | None = None,
                        softcap: float | None = None):
    """``(out, lse)``: ``flash_attention``'s output and each row's
    log-sum-exp, fp32 ``[B, Kh, Sq * G]`` (``ref.flash_attention_ref``'s
    ``return_lse``), from one launch of the ``rows`` route; raises where
    ``route`` picks another.  Not differentiable."""
    _check(q, k, v)
    _check_options(window, softcap)
    which = route(q, k, v)
    if which != "rows":
        raise ValueError(f"{NAME}: the log-sum-exp comes from the rows "
                         f"route; this call takes {which}")
    return _forward(q, k, v, q_start, kv_len, window, softcap, lse=True)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient from ``flash_attention_bwd``
    (``q_start`` and ``kv_len`` ints or ``[B]`` int tensors, passed on as
    given).  Where ``saves_lse`` holds, the output and its log-sum-exp are
    saved and the backward takes its ``saved`` route; under
    ``torch.utils.checkpoint`` the recompute produces both again."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, kv_len, window, softcap):
        out, lse = _forward(q, k, v, q_start, kv_len, window, softcap,
                            lse=saves_lse(q, k, v))
        pos = (q_start, kv_len)
        ctx.ints = [None if isinstance(p, torch.Tensor) else p for p in pos]
        ctx.save_for_backward(q, k, v, None if lse is None else out, lse,
                              *(p for p in pos if isinstance(p,
                                                             torch.Tensor)))
        ctx.options = {"window": window, "softcap": softcap}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *tensors = ctx.saved_tensors
        tensors = iter(tensors)
        q_start, kv_len = (next(tensors) if p is None else p
                           for p in ctx.ints)
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, q_start, kv_len,
                                         out=out, lse=lse, **ctx.options)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, q_start, kv_len, window, softcap, lse=False):
    """One forward launch on the route ``route`` picks (or the plain
    version on the CPU); the operands are checked.  Returns ``(out,
    lse)``: with ``lse`` (the ``rows`` route only) each row's log-sum-exp,
    else None."""
    device = q.device
    if device.type == "cpu":
        if lse:
            return flash_attention_ref(q, k, v, q_start, kv_len,
                                       window=window, softcap=softcap,
                                       return_lse=True)
        return flash_attention_ref(q, k, v, q_start, kv_len, window=window,
                                   softcap=softcap), None
    if device.type == "meta":
        return _meta_forward(q, k, v, q_start, kv_len, window, lse)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    B, Sq, Kh, G, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} is not one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {q.dtype} is not float32 or "
                        f"bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} is not 16-byte aligned")
    starts = per_batch(q_start, B, device).contiguous()
    lens = per_batch(kv_len, B, device).contiguous()
    out = torch.empty_like(q)
    which = route(q, k, v)
    rows_lse = None
    if lse:
        if which != "rows":
            raise ValueError(f"{NAME}: no log-sum-exp on the {which} route")
        rows_lse = torch.empty((B, Kh, Sq * G), dtype=torch.float32,
                               device=device)
    if out.numel() == 0:
        return out, rows_lse
    Skv = k.shape[1]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
            lens.data_ptr(), out.data_ptr()]
    tail = [_NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap)]
    if which == "split":
        # fp32 partial (m, l, acc) per (batch, kv head, chunk, row); the
        # chunk count follows Skv alone, so kv_len is never read here
        n_split = max(1, -(-Skv // SPLIT_KEYS))
        rows = B * Kh * n_split * Sq * G
        scratch = torch.empty(rows * (2 + hd), dtype=torch.float32,
                              device=device)
        args += [scratch.data_ptr(), scratch[rows:].data_ptr(),
                 scratch[2 * rows:].data_ptr()]
        tail += [_DTYPES[q.dtype], n_split]
    elif which == "rows":
        args.append(0 if rows_lse is None else rows_lse.data_ptr())
        tail.append(_DTYPES[q.dtype])
    fn = _kernel_fn(which)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, B, Sq, Skv, Kh, G, hd, *tail, stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: {which} kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    count_launch(f"{NAME}.{which}")
    return out, rows_lse


def _meta_forward(q, k, v, q_start, kv_len, window, lse):
    """The forward on the meta device: empty outputs, the kernel's work
    reported."""
    B, Sq, Kh, G, hd = q.shape
    out = torch.empty_like(q)
    pairs = admissible_pairs(B, Sq, k.shape[1], q_start, kv_len,
                             window) * Kh * G
    report_meta(NAME, 4 * hd * pairs, nbytes(q, k, v, out), q.dtype)
    rows_lse = (torch.empty((B, Kh, Sq * G), dtype=torch.float32,
                            device=q.device) if lse else None)
    return out, rows_lse


def _bwd_kernel_fn():
    fn = _build.load(BWD_SOURCE).flash_attention_bwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, dout, q_start, kv_len, out, lse, dq, dk, dv, lse_buf,
        # dsum, then B, Sq, Skv, Kh, G, hd, window, softcap
        fn.argtypes = [p] * 13 + [i] * 7 + [f, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_tc_kernel_fn():
    fn = _build.load(BWD_TC_SOURCE).flash_attention_bwd_tc
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, dout, q_start, kv_len, dq, dk, dv, lse, dsum, then B,
        # Sq, Skv, Kh, G, hd, window, softcap
        fn.argtypes = [p] * 11 + [i] * 7 + [f, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, q_start, kv_len, *,
                        window: int | None = None,
                        softcap: float | None = None,
                        out: torch.Tensor | None = None,
                        lse: torch.Tensor | None = None):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention`` at (q, k, v)
    for the output gradient ``dout`` (``[B, Sq, Kh, G, hd]``), in q.dtype.
    On the ``tc`` route (``bwd_route``) the kernels read the bf16 operands
    and write bf16 gradients, forming each row's statistics themselves
    (``out`` and ``lse``, if given, are not read).  Otherwise, with the
    forward's ``out`` and ``lse`` (``flash_attention_lse``) the ``saved``
    route reads them; without, the ``recompute`` route recomputes both in
    fp32 (bf16's output is rounded); those kernels work in fp32: bf16
    operands are cast to fp32 and the gradients back.  On a CUDA device it
    launches the route's kernels on the current stream (built with nvcc at
    first use), or raises; on the CPU it runs the plain version."""
    _check(q, k, v)
    _check_options(window, softcap)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"{BWD_NAME}: dout {tuple(dout.shape)} on "
                         f"{dout.device} does not fit q {tuple(q.shape)}")
    B, Sq, Kh, G, hd = q.shape
    given = out is not None and lse is not None
    if given:
        if out.shape != q.shape or out.device != q.device:
            raise ValueError(f"{BWD_NAME}: out {tuple(out.shape)} on "
                             f"{out.device} does not fit q "
                             f"{tuple(q.shape)}")
        if (lse.shape != (B, Kh, Sq * G) or lse.dtype != torch.float32
                or lse.device != q.device):
            raise ValueError(f"{BWD_NAME}: lse must be float32 "
                             f"{(B, Kh, Sq * G)} on {q.device}, got "
                             f"{lse.dtype} {tuple(lse.shape)} on "
                             f"{lse.device}")
    else:
        out = lse = None
    device = q.device
    if device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout.to(q.dtype), q_start,
                                       kv_len, window=window,
                                       softcap=softcap, out=out, lse=lse)
    if device.type == "meta":
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        pairs = admissible_pairs(B, Sq, k.shape[1], q_start, kv_len,
                                 window) * Kh * G
        report_meta(BWD_NAME, 10 * hd * pairs,
                    nbytes(q, k, v, dout, out, lse, *grads), q.dtype)
        return grads
    if device.type != "cuda":
        raise ValueError(f"{BWD_NAME}: no kernel for device {device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{BWD_NAME}: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{BWD_NAME}: dtype {q.dtype} is not float32 or "
                        f"bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{BWD_NAME}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{BWD_NAME}: {name} is not 16-byte aligned")
    if bwd_route(q, k, v) == "tc":
        return _bwd_tc(q, k, v, dout, q_start, kv_len, window, softcap)
    which = "saved" if given else "recompute"
    # the kernels read contiguous fp32 rows: autograd's output gradient may
    # be strided or of another dtype (it is taken in q's, as on the CPU),
    # and bf16 operands are widened
    q32, k32, v32, do32 = (t.to(torch.float32).contiguous()
                           for t in (q, k, v, dout.to(q.dtype)))
    starts = per_batch(q_start, B, device).contiguous()
    lens = per_batch(kv_len, B, device).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q32, k32, v32))
    if q.numel() == 0 or k.numel() == 0:
        return tuple(t.zero_().to(q.dtype) for t in (dq, dk, dv))
    rows = B * Kh * Sq * G
    # D rows, and on the recompute route the log-sum-exp after them
    scratch = torch.empty(rows * (1 if out is not None else 2),
                          dtype=torch.float32, device=device)
    ptrs = [0, 0, 0]     # out, lse, lse_buf
    if out is not None:
        out = out.to(torch.float32).contiguous()
        lse = lse.contiguous()
        ptrs[:2] = out.data_ptr(), lse.data_ptr()
    else:
        ptrs[2] = scratch[rows:].data_ptr()
    fn = _bwd_kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                 do32.data_ptr(), starts.data_ptr(), lens.data_ptr(),
                 ptrs[0], ptrs[1], dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), ptrs[2], scratch.data_ptr(), B, Sq,
                 k.shape[1], Kh, G, hd,
                 _NO_WINDOW if window is None else int(window),
                 0.0 if softcap is None else float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME}: {which} kernel launch failed with "
                           f"CUDA error {err}")
    count_launch(BWD_NAME)
    count_launch(f"{BWD_NAME}.{which}")
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _bwd_tc(q, k, v, dout, q_start, kv_len, window, softcap):
    """The ``tc`` route on checked CUDA operands: bf16 gradients from the
    three kernels of ``csrc/flash_attention_bwd_tc.cu``, whose fp32
    scratch holds each row's log-sum-exp and D, ``[B, Kh, R_pad]`` each
    (R = Sq * G rounded up to the kernels' 128-row blocks)."""
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    device = q.device
    # autograd's output gradient may be strided, of another dtype, or a view
    # off TMA's 16-byte alignment
    do = dout.to(q.dtype).contiguous()
    if do.data_ptr() % 16:
        do = do.clone()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    starts = per_batch(q_start, B, device).contiguous()
    lens = per_batch(kv_len, B, device).contiguous()
    r_pad = -(-Sq * G // TC_ROWS) * TC_ROWS
    stats = torch.empty(2 * B * Kh * r_pad, dtype=torch.float32,
                        device=device)
    fn = _bwd_tc_kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 starts.data_ptr(), lens.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                 stats[B * Kh * r_pad:].data_ptr(), B, Sq, Skv, Kh, G, hd,
                 _NO_WINDOW if window is None else int(window),
                 0.0 if softcap is None else float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME}: tc kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(BWD_NAME)
    count_launch(f"{BWD_NAME}.tc")
    return dq, dk, dv
