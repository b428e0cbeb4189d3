"""Wrapper of the grouped matmul kernel.

``grouped_matmul(x, w)`` computes ``x[G, M, K] @ w[G, K, N]`` with fp32
accumulation, in x.dtype.  On a CUDA device it launches one of the two
kernels in ``csrc/grouped_matmul.cu`` (built with nvcc at first use) on the
current stream, or raises; it never falls back.  ``route`` picks the kernel
before the launch, from dtype, shape and alignment alone: the tensor-core
kernel (``"tc"``: TMA and wgmma) for bf16 whose rows TMA can address, the
scalar kernel (``"simt"``) for the rest.  On the CPU it runs the plain
version in ``ref.py``.

Under autograd (grad enabled and an operand that requires it) the call
goes through ``GroupedMatmulFn``, whose backward is two more launches of
the same kernel: ``dx = grouped_matmul(dy, w^T)`` and ``dw =
grouped_matmul(x^T, dy)``, the transposes made contiguous first (the
kernel takes no strides), each routed by ``route`` as any call is; on CPU
tensors the same Function runs over the plain version.

Launch counts (``repro_torch.kernels.LAUNCHES``): ``grouped_matmul`` for
every launch, and ``grouped_matmul.tc`` or ``grouped_matmul.simt`` for the
route taken.
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


def _kernel_fn(route_name: str):
    lib = _build.load(SOURCE)
    fn = lib.grouped_matmul_tc if route_name == "tc" else lib.grouped_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # the scalar kernel also takes a dtype code
        ints = [i] * (4 if route_name == "tc" else 5)
        fn.argtypes = [p, p, p, *ints, p]
        fn.restype = ctypes.c_int
    return fn


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"tc"`` where TMA can address both operands: bf16, K and N
    multiples of 8 (rows of 16-byte multiples), K > 0 and both bases
    16-byte aligned; ``"simt"`` otherwise (fp32 included: the reference
    sums in full fp32, so TF32 tensor cores are not used).  Reads only
    dtype, shape and ``data_ptr``, so it decides on any device."""
    K, N = x.shape[2], w.shape[2]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and K > 0 and K % 8 == 0 and N % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tc"
    return "simt"


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[G, M, K]`` @ w ``[G, K, N]`` -> ``[G, M, N]`` in x.dtype,
    differentiable in both operands."""
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in (x, w)):
        return GroupedMatmulFn.apply(x, w)
    return _grouped_matmul(x, w)


class GroupedMatmulFn(torch.autograd.Function):
    """The grouped product with its gradients as two more grouped
    products: ``dx = dy @ w^T`` and ``dw = x^T @ dy`` per group."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_matmul(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = _grouped_matmul(x.transpose(1, 2).contiguous(), dy)
        return dx, dw


def _grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel (or the plain version on the CPU)."""
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
    which = route(x, w)
    fn = _kernel_fn(which)
    args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N]
    if which == "simt":
        args.append(_DTYPES[x.dtype])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: {which} kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    count_launch(f"{NAME}.{which}")
    return out
