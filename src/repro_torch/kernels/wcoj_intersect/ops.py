"""Wrapper of the WCOJ membership-probe kernels, and the search index the
``fence`` route walks.

``wcoj_intersect(indptr, indices, rows, targets, pos_map=None,
index=None)`` takes int32 tensors of one device.  On a CUDA device it
launches one of the two kernels in ``csrc/wcoj_intersect.cu`` (built with
nvcc at first use) on the current stream, or raises; it never falls back.
``route`` picks the kernel before the launch: ``"fence"`` (a walk down
``index``, one aligned node a level; rows of fewer than ``SMALL_ROW`` keys
binary-searched in place) where an index is given and both bases are
32-byte aligned, ``"search"`` (a binary search over the row) otherwise.
On the CPU it runs the plain version in ``ref.py``.  On the meta device
(the dry run) it returns empty outputs and reports the kernel's work
(``kernels.report_meta``: no flops; the rows and targets, two ``indptr``
entries a probe, and the outputs), and runs neither a kernel nor the plain
version.

``build_search_index(indices)`` builds the index once per CSR, on the CSR's
device, with no host sync: level 1 is ``indices[::NODE]`` (the first key of
every aligned ``NODE``-slot block), level 2 ``level1[::NODE]``, and so on
until a level has at most ``NODE`` entries.  The levels lie back to back in
one int32 tensor, level 1 first, each padded with ``INT32_MAX`` to whole
nodes, so every level's offset follows from ``nnz`` (``search_levels``).

Launch counts (``repro_torch.kernels.LAUNCHES``): ``wcoj_intersect`` for
every launch, and ``wcoj_intersect.fence`` or ``wcoj_intersect.search`` for
the route taken.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, count_launch, nbytes, report_meta
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref

NAME = "wcoj_intersect"
SOURCE = Path(__file__).resolve().parent / "csrc" / "wcoj_intersect.cu"
NODE = 8            # keys a node: 32 bytes, one sector
ALIGN = 32          # bytes: a node of indices or of the index is one sector
SMALL_ROW = 32      # the fence kernel binary-searches rows of fewer keys
INT32_MAX = 2 ** 31 - 1


def search_levels(nnz: int, node: int = NODE) -> list[tuple[int, int]]:
    """``(offset, entries)`` of each index level over ``nnz`` keys, level 1
    first; a level takes ``entries`` rounded up to whole nodes."""
    levels, n, off = [], int(nnz), 0
    while n > node:
        n = -(-n // node)
        levels.append((off, n))
        off += -(-n // node) * node
    return levels


def search_index_size(nnz: int, node: int = NODE) -> int:
    """Entries of the index over ``nnz`` keys (about ``nnz / (node - 1)``)."""
    levels = search_levels(nnz, node)
    if not levels:
        return 0
    off, n = levels[-1]
    return off + -(-n // node) * node


def build_search_index(indices: torch.Tensor,
                       node: int = NODE) -> torch.Tensor:
    """The fence index of a CSR's ``indices`` (module docstring), built
    with strided slices on the tensor's own device."""
    parts, level = [], indices
    while level.shape[0] > node:
        level = level[::node]
        parts.append(level)
        pad = -level.shape[0] % node
        if pad:
            parts.append(level.new_full((pad,), INT32_MAX))
    if not parts:
        return indices.new_empty(0)
    return torch.cat(parts)


def route(indices: torch.Tensor, index: torch.Tensor | None) -> str:
    """``"fence"`` where ``index`` is given and the bases of ``indices``
    and ``index`` are 32-byte aligned, so each node is one sector;
    ``"search"`` otherwise.  An index whose size does not follow from
    ``nnz`` belongs to another CSR and raises.  Reads only shapes and
    ``data_ptr``, so it decides on any device."""
    if index is None:
        return "search"
    want = search_index_size(indices.shape[0])
    if index.shape[0] != want:
        raise ValueError(f"{NAME}: index has {index.shape[0]} entries, a "
                         f"CSR of {indices.shape[0]} keys needs {want}")
    if indices.data_ptr() % ALIGN or index.data_ptr() % ALIGN:
        return "search"
    return "fence"


def _probe_fn(which: str):
    lib = _build.load(SOURCE)
    fn = getattr(lib, f"wcoj_probe_{which}")
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        # indptr, indices, index, rows, targets, pos_map, nnz, n, found,
        # epos, stream
        fn.argtypes = [p, p, p, p, p, p, i64, i64, p, p, p]
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
                   pos_map: torch.Tensor | None = None,
                   index: torch.Tensor | None = None):
    """Is ``targets[i]`` in CSR row ``rows[i]``?  Returns ``(found bool,
    epos int32)`` as ``ref.wcoj_intersect_ref`` defines them.
    ``rows`` must index real rows (``0 <= rows[i] < len(indptr) - 1``);
    ``index`` is ``build_search_index(indices)``, or None."""
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
    if index is not None:
        _check("index", index, device)
    if rows.shape[0] != targets.shape[0]:
        raise ValueError(f"{NAME}: {rows.shape[0]} rows but "
                         f"{targets.shape[0]} targets")
    if indptr.shape[0] < 1:
        raise ValueError(f"{NAME}: indptr is empty")
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{NAME}: {rows.shape[0]} probes; the kernels "
                         f"index probes with 32 bits")
    which = route(indices, index)
    if device.type == "cpu":
        return wcoj_intersect_ref(indptr, indices, rows, targets, pos_map)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"{NAME}: no kernel for device {device}")
    n = rows.shape[0]
    found = torch.empty(n, dtype=torch.bool, device=device)
    epos = torch.empty(n, dtype=torch.int32, device=device)
    if device.type == "meta":
        report_meta(NAME, 0, nbytes(rows, targets, found, epos)
                    + 2 * n * indptr.element_size(), indices.dtype)
        return found, epos
    if n == 0:
        return found, epos
    fn = _probe_fn(which)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(),
                 index.data_ptr() if which == "fence" else None,
                 rows.data_ptr(), targets.data_ptr(),
                 pos_map.data_ptr() if pos_map is not None else None,
                 indices.shape[0], n, found.data_ptr(), epos.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: {which} kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    count_launch(f"{NAME}.{which}")
    return found, epos
