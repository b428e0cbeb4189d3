"""Host-staging adapter: the executor/backend contract from before
OperatorSet v2, kept as a measurable baseline (the port of
``src/repro/graphdb/host_staging.py``).

``HostStagingOperators`` runs the old data plane over a device operator
set: binding-table columns live in host numpy, the relational tail runs on
the host path, and the pattern operators run on the device *per call* —
uploading the row block, building the padded ``[R, D_max]`` neighbour and
validity blocks, downloading those padded blocks and compacting them back
to flat rows **on the host**.  Every transfer registers on the wrapped
set's ``TransferStats``, so a residency comparison can put a number on
what OperatorSet v2 removes (zero mid-plan ``d2h``, no padded-block round
trips), query by query, against the device-resident path.

The reference pads and slabs as its jit programs demand; the torch set
needs neither, so the constants below are copies of the reference's
(``jax_backend.py``), kept to stage the same blocks.  Its membership probe
splits by degree between a padded-ELL Pallas tile and a binary search;
here one ``wcoj_intersect`` (K1) launch a slab covers every degree, on the
inner set's device CSR and search index.  K1 gets no position map: the
hits are mapped through ``csr.pos`` on the host, as the reference maps
them.  Each launch records one ``dispatch:intersect`` on this set's
``kernel_stats``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.physical_spec import OperatorSet
from repro_torch.graphdb import torchops
from repro_torch.graphdb.numpy_backend import NumpyOperators
from repro_torch.kernels.wcoj_intersect.ops import wcoj_intersect

_MIN_BLOCK_ROWS = 8
# rows per device slab: padded blocks are [slab, D_max]; slabbing bounds the
# padded footprint and lets D_max adapt to each slab's real degree skew
_SLAB_ROWS = 1 << 15
# element budget for one [rows, D_max] padded expand block
_EXPAND_ELEMS = 1 << 25


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


class HostStagingOperators(NumpyOperators):
    """Round-trip execution over a device operator set (``inner``, a
    ``TorchOperators``)."""

    def __init__(self, inner: OperatorSet):
        super().__init__(inner.store)
        self.inner = inner
        self.name = f"host_staged[{inner.name}]"
        # shared ledger: the wrapper's per-op round trips show up exactly
        # where the device backend would have avoided them
        self.transfer_stats = inner.transfer_stats

    # host pad + recorded up/downloads ------------------------------------
    @staticmethod
    def _pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
        out = np.full(n, fill, dtype=a.dtype)
        out[:a.shape[0]] = a
        return out

    def _up(self, a: np.ndarray):
        return self.inner.asarray(a)

    def _down(self, x) -> np.ndarray:
        return np.asarray(self.inner.to_host(x))

    # ------------------------------------------------------------- expand
    def expand(self, csr, rows_local, max_out=None):
        """Padded block on the device, flattened on the host."""
        rows_local = np.asarray(rows_local, dtype=np.int64)
        R = rows_local.shape[0]
        deg = csr.indptr[rows_local + 1] - csr.indptr[rows_local]
        total = int(deg.sum())
        if max_out is not None and total > max_out:
            raise RuntimeError(f"intermediate blow-up: expansion would "
                               f"produce {total} rows > cap {max_out}")
        if total == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        parts = []
        for s in range(0, R, _SLAB_ROWS):
            e = min(s + _SLAB_ROWS, R)
            self._expand_chunk(csr, rows_local[s:e], deg[s:e], s, parts)
        ridx = np.concatenate([p[0] for p in parts])
        nbr = np.concatenate([p[1] for p in parts])
        fpos = np.concatenate([p[2] for p in parts])
        epos = csr.pos[fpos] if csr.pos is not None else fpos
        return ridx, nbr, epos

    def _expand_chunk(self, csr, rows_local, deg, base, parts):
        """Halve the chunk while the padded [rows, d_max] block would bust
        the element budget (degree-skew isolation)."""
        if int(deg.sum()) == 0:
            return
        d_hi = int(deg.max())
        R = rows_local.shape[0]
        if R > 1 and (_pow2(R, _MIN_BLOCK_ROWS) * _pow2(d_hi)
                      > _EXPAND_ELEMS):
            h = R // 2
            self._expand_chunk(csr, rows_local[:h], deg[:h], base, parts)
            self._expand_chunk(csr, rows_local[h:], deg[h:], base + h, parts)
            return
        ridx, nbr, fpos = self._expand_slab(csr, rows_local, d_hi)
        parts.append((ridx + base, nbr, fpos))

    def _expand_slab(self, csr, rows_local, d_hi):
        indptr_d, indices_d, _pos, _index = self.inner._csr_dev(csr)
        d_max = _pow2(d_hi)
        rp = _pow2(rows_local.shape[0], _MIN_BLOCK_ROWS)
        rows_p = self._pad_rows(rows_local, rp, 0).astype(np.int32)
        nbr, valid, flat = torchops.expand_padded(
            indptr_d, indices_d, self._up(rows_p), d_max)
        # download the PADDED blocks, flatten on the host
        R = rows_local.shape[0]
        valid = self._down(valid)[:R]
        ridx, _slot = np.nonzero(valid)
        nbr_flat = self._down(nbr)[:R][valid].astype(np.int64)
        fpos = self._down(flat)[:R][valid].astype(np.int64)
        return ridx.astype(np.int64), nbr_flat, fpos

    # ---------------------------------------------------------- intersect
    def intersect(self, csr, rows_local, targets):
        rows_local = np.asarray(rows_local, dtype=np.int64)
        targets = np.asarray(targets, dtype=np.int64)
        R = rows_local.shape[0]
        found = np.zeros(R, dtype=bool)
        fpos = np.zeros(R, dtype=np.int64)
        if R == 0:
            return found, fpos
        deg = csr.indptr[rows_local + 1] - csr.indptr[rows_local]
        for s in range(0, R, _SLAB_ROWS):
            e = min(s + _SLAB_ROWS, R)
            if int(deg[s:e].max()) == 0:
                continue
            found[s:e], fpos[s:e] = self._intersect_slab(
                csr, rows_local[s:e], targets[s:e])
        epos = np.zeros(R, dtype=np.int64)
        if found.any():
            hp = fpos[found]
            epos[found] = csr.pos[hp] if csr.pos is not None else hp
        return found, epos

    def _intersect_slab(self, csr, rows_local, targets):
        """One K1 launch on a padded slab (rows padded with row 0, targets
        with -2, which no row holds): the hits and their flat slots."""
        indptr_d, indices_d, _pos, index = self.inner._csr_dev(csr,
                                                               probe=True)
        R = rows_local.shape[0]
        rp = _pow2(R, _MIN_BLOCK_ROWS)
        rows_p = self._pad_rows(rows_local, rp, 0).astype(np.int32)
        tgt_p = self._pad_rows(targets, rp, -2).astype(np.int32)
        self.kernel_stats.record("dispatch", "intersect")
        found_d, pos_d = wcoj_intersect(indptr_d, indices_d,
                                        self._up(rows_p), self._up(tgt_p),
                                        None, index)
        found = self._down(found_d)[:R].astype(bool)
        return found, self._down(pos_d)[:R].astype(np.int64)
