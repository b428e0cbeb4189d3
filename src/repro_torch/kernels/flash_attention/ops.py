"""Wrapper of the FlashAttention forward kernel.

``flash_attention(q, k, v, q_start, kv_len, window=None, softcap=None)``
takes the model's layout (``ref.flash_attention_ref`` defines the
function).  On a CUDA device it launches the kernel in
``csrc/flash_attention.cu`` (built with nvcc at first use) on the current
stream, or raises; it never falls back.  On the CPU it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     per_batch)

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NO_WINDOW = 1 << 30


def _fwd_fn():
    fn = _build.load(SOURCE).flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_start, kv_len, *, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q ``[B, Sq, Kh, G, hd]``; k, v ``[B, Skv, Kh, hd]`` (a cache, read in
    place); ``q_start``, ``kv_len`` ints or ``[B]`` int tensors.  Returns
    ``[B, Sq, Kh, G, hd]`` in q.dtype."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{NAME}: softcap must be > 0, got {softcap}")
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, q_start, kv_len, window=window,
                                   softcap=softcap)
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
    if out.numel() == 0:
        return out
    fn = _fwd_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], Kh, G,
                 hd, _NO_WINDOW if window is None else int(window),
                 0.0 if softcap is None else float(softcap), _DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(NAME)
    return out
