"""Wrapper of the WCOJ membership-probe kernel.

``wcoj_intersect(indptr, indices, rows, targets, pos_map=None)`` takes
int32 tensors of one device.  On a CUDA device it launches the kernel in
``csrc/wcoj_intersect.cu`` (built with nvcc at first use) on the current
stream, or raises; it never falls back.  On the CPU it runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref

NAME = "wcoj_intersect"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wcoj_intersect.cu"


def _probe_fn():
    lib = _build.load(SOURCE)
    fn = lib.wcoj_probe
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int64, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{NAME}: {name} must be a tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{NAME}: {name} must be int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{NAME}: {name} must be 1-D and contiguous")
    if t.device != device:
        raise ValueError(f"{NAME}: {name} is on {t.device}, expected "
                         f"{device}")


def wcoj_intersect(indptr: torch.Tensor, indices: torch.Tensor,
                   rows: torch.Tensor, targets: torch.Tensor,
                   pos_map: torch.Tensor | None = None):
    """Is ``targets[i]`` in CSR row ``rows[i]``?  Returns ``(found bool,
    epos int32)`` as ``ref.wcoj_intersect_ref`` defines them.
    ``rows`` must index real rows (``0 <= rows[i] < len(indptr) - 1``)."""
    device = indptr.device
    _check("indptr", indptr, device)
    _check("indices", indices, device)
    _check("rows", rows, device)
    _check("targets", targets, device)
    if pos_map is not None:
        _check("pos_map", pos_map, device)
        if pos_map.shape[0] != indices.shape[0]:
            raise ValueError(f"{NAME}: pos_map has {pos_map.shape[0]} "
                             f"entries, indices {indices.shape[0]}")
    if rows.shape[0] != targets.shape[0]:
        raise ValueError(f"{NAME}: {rows.shape[0]} rows but "
                         f"{targets.shape[0]} targets")
    if indptr.shape[0] < 1:
        raise ValueError(f"{NAME}: indptr is empty")
    if device.type == "cpu":
        return wcoj_intersect_ref(indptr, indices, rows, targets, pos_map)
    if device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {device}")
    n = rows.shape[0]
    found = torch.empty(n, dtype=torch.bool, device=device)
    epos = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return found, epos
    fn = _probe_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(), rows.data_ptr(),
                 targets.data_ptr(),
                 pos_map.data_ptr() if pos_map is not None else None,
                 n, found.data_ptr(), epos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(NAME)
    return found, epos
