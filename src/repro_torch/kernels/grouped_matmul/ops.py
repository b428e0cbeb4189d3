"""Wrapper of the grouped matmul kernel.

``grouped_matmul(x, w, trans_x=False, trans_w=False)`` computes ``op(x)[G,
M, K] @ op(w)[G, K, N]`` with fp32 accumulation, in x.dtype, where
``trans_x`` gives x stored ``[G, K, M]`` and ``trans_w`` w stored ``[G, N,
K]`` (``ref.grouped_matmul_ref`` defines the function).  On a CUDA device
it launches one of the two kernels in ``csrc/grouped_matmul.cu`` (built
with nvcc at first use) on the current stream, or raises; it never falls
back.  ``route`` picks the kernel before the launch, from dtype, shape and
alignment alone: the tensor-core kernel (``"tc"``: TMA and wgmma) for bf16
whose rows TMA can address, the scalar kernel (``"simt"``) for the rest,
which reads both layouts in place, on the output tiles ``simt_tile``
picks.  The tensor-core kernel takes no layout flags: a
transposed operand routed there is copied into its logical layout first.
On the CPU it runs the plain version in ``ref.py``.

Under autograd (grad enabled and an operand that requires it) the call
goes through ``GroupedMatmulFn``, whose backward is two more calls of the
wrapper with layout flags: ``dx = dy @ w^T`` reads w in place
(``trans_w``) and ``dw = x^T @ dy`` reads x in place (``trans_x``), each
routed by ``route`` as any call is; on CPU tensors the same Function runs
over the plain version.

Launch counts (``repro_torch.kernels.LAUNCHES``): ``grouped_matmul`` for
every call, and ``grouped_matmul.tc`` or ``grouped_matmul.simt`` for the
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
# the simt kernel's output tile rows (64 * H of the source) and columns,
# and the H100's SM count, which sets how many tiles keep the card busy
SIMT_TILE_ROWS, SIMT_TILE_COLS, SIMT_SMS = (128, 64), 128, 132


def _kernel_fn(route_name: str):
    lib = _build.load(SOURCE)
    fn = lib.grouped_matmul_tc if route_name == "tc" else lib.grouped_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if route_name == "tc":
            # x, w, out, G, M, K, N
            fn.argtypes = [p, p, p, i, i, i, i, p]
        else:
            # x, w, out, G, M, K, N, trans_x, trans_w, tile_m, vec, dtype
            fn.argtypes = [p] * 3 + [i] * 9 + [p]
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def simt_tile(G: int, M: int, N: int) -> int:
    """The rows of the simt kernel's output tile for a ``[G, M, K] @ [G, K,
    N]`` product, from its shape alone: 128 (128 x 128 tiles, 8 x 8 a
    thread), or 64 (64 x 128, 4 x 8) where 128-row tiles would leave SMs
    idle (fewer tiles than SMs: ``lm-moe``'s dw, 64 tiles) or most of a
    tile's rows empty (M <= 64: decode).  K is never split: every output
    sums its K products in order, as the plain version does."""
    tall, short = SIMT_TILE_ROWS
    tiles = G * _cdiv(M, tall) * _cdiv(N, SIMT_TILE_COLS)
    return short if M <= short or tiles < SIMT_SMS else tall


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   trans_x: bool = False,
                   trans_w: bool = False) -> torch.Tensor:
    """op(x) ``[G, M, K]`` @ op(w) ``[G, K, N]`` -> ``[G, M, N]`` in
    x.dtype, differentiable in both operands; x is given ``[G, K, M]``
    with ``trans_x``, w ``[G, N, K]`` with ``trans_w``."""
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in (x, w)):
        return GroupedMatmulFn.apply(x, w, trans_x, trans_w)
    return _grouped_matmul(x, w, trans_x, trans_w)


class GroupedMatmulFn(torch.autograd.Function):
    """The grouped product with its gradients as two more grouped
    products, each reading its operands in place through the layout
    flags: ``d op(x) = dy op(w)^T`` and ``d op(w) = op(x)^T dy`` per
    group (transposed again for an operand stored transposed)."""

    @staticmethod
    def forward(ctx, x, w, trans_x=False, trans_w=False):
        ctx.save_for_backward(x, w)
        ctx.trans = (trans_x, trans_w)
        return _grouped_matmul(x, w, trans_x, trans_w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        tx, tw = ctx.trans
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # x stored [K, M] takes (dy op(w)^T)^T = op(w) dy^T
            dx = (_grouped_matmul(w, dy, tw, True) if tx
                  else _grouped_matmul(dy, w, False, not tw))
        if ctx.needs_input_grad[1]:
            # w stored [N, K] takes (op(x)^T dy)^T = dy^T op(x)
            dw = (_grouped_matmul(dy, x, True, tx) if tw
                  else _grouped_matmul(x, dy, not tx, False))
        return dx, dw, None, None


def _grouped_matmul(x: torch.Tensor, w: torch.Tensor, trans_x: bool = False,
                    trans_w: bool = False) -> torch.Tensor:
    """One call of the kernel (or the plain version on the CPU)."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
            and x.dim() == 3 and w.dim() == 3):
        raise ValueError(f"{NAME}: x and w must be 3-D tensors")
    G = x.shape[0]
    M, K = (x.shape[2], x.shape[1]) if trans_x else x.shape[1:]
    Kw, N = (w.shape[2], w.shape[1]) if trans_w else w.shape[1:]
    if w.shape[0] != G or Kw != K:
        raise ValueError(f"{NAME}: w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)} (trans_x {trans_x}, trans_w "
                         f"{trans_w})")
    if x.dtype != w.dtype:
        raise TypeError(f"{NAME}: x is {x.dtype}, w is {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{NAME}: x is on {x.device}, w on {w.device}")
    device = x.device
    if device.type == "cpu":
        return grouped_matmul_ref(x, w, trans_x=trans_x, trans_w=trans_w)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: dtype {x.dtype} is not float32 or "
                        f"bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{NAME}: x and w must be contiguous")
    out = torch.empty((G, M, N), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    # the logical operands (views: the same bases) decide the route
    xl = x.transpose(1, 2) if trans_x else x
    wl = w.transpose(1, 2) if trans_w else w
    which = route(xl, wl)
    if which == "tc":
        xl, wl = xl.contiguous(), wl.contiguous()
        args = [xl.data_ptr(), wl.data_ptr(), out.data_ptr(), G, M, K, N]
    else:
        vec = (x.dtype == torch.float32 and M % 4 == K % 4 == N % 4 == 0
               and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N,
                int(trans_x), int(trans_w), simt_tile(G, M, N), int(vec),
                _DTYPES[x.dtype]]
    fn = _kernel_fn(which)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: {which} kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    count_launch(f"{NAME}.{which}")
    return out
