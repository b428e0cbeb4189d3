"""Wrapper of the grouped matmul kernel.

``grouped_matmul(x, w)`` computes ``x[G, M, K] @ w[G, K, N]`` with fp32
accumulation, in x.dtype.  On a CUDA device it launches the kernel in
``csrc/grouped_matmul.cu`` (built with nvcc at first use) on the current
stream, or raises; it never falls back.  On the CPU it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

NAME = "grouped_matmul"
SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gmm_fn():
    fn = _build.load(SOURCE).grouped_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[G, M, K]`` @ w ``[G, K, N]`` -> ``[G, M, N]`` in x.dtype."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
            and x.dim() == 3 and w.dim() == 3):
        raise ValueError(f"{NAME}: x and w must be 3-D tensors")
    G, M, K = x.shape
    if w.shape[0] != G or w.shape[1] != K:
        raise ValueError(f"{NAME}: w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"{NAME}: x is {x.dtype}, w is {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{NAME}: x is on {x.device}, w on {w.device}")
    device = x.device
    if device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {x.dtype} is not float32 or "
                        f"bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{NAME}: x and w must be contiguous")
    N = w.shape[2]
    out = torch.empty((G, M, N), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _gmm_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N,
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(NAME)
    return out
