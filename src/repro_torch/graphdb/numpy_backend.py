"""Numpy backend — the host path of the binding-table engine.

Registers the ``"numpy"`` PhysicalSpec: every core operator is the
corresponding ``repro_torch.graphdb.vecops`` primitive (flat gathers, sorted
binary search, sort-merge join, segmented reductions), and the v2 array
primitives (``take``/``mask``/``concat``/...) are the host-numpy defaults
inherited from ``OperatorSet`` — for this backend ``to_host`` is the
identity and ``transfer_stats`` stays empty.  This is the seed engine's
original execution path, declared through the registry (DESIGN.md §2/§7).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.physical_spec import (CostParams, OperatorSet, PhysicalSpec,
                                      register_spec)
from repro_torch.graphdb import vecops


class NumpyOperators(OperatorSet):
    name = "numpy"

    def scan(self, lo: int, hi: int) -> np.ndarray:
        return np.arange(lo, hi, dtype=np.int64)

    def expand(self, csr, rows_local, max_out=None):
        return vecops.expand_csr(csr.indptr, csr.indices, rows_local,
                                 csr.pos, max_out=max_out)

    def intersect(self, csr, rows_local, targets):
        found, pos = vecops.bounded_binary_search(
            csr.indices, csr.indptr[rows_local],
            csr.indptr[rows_local + 1], targets)
        epos = np.zeros(pos.shape, dtype=np.int64)
        if found.any():
            fpos = pos[found]
            epos[found] = csr.pos[fpos] if csr.pos is not None else fpos
        return found, epos

    def join(self, lkeys, rkeys, max_out=None):
        return vecops.equi_join(lkeys, rkeys, max_out=max_out)

    def combine_keys(self, cols):
        return vecops.combine_keys(cols)

    def group_reduce(self, keys, values):
        return vecops.group_reduce(keys, values)


NUMPY_SPEC = register_spec(PhysicalSpec(
    name="numpy",
    make_operators=NumpyOperators,
    cost=CostParams(),
    description="host numpy vecops path (sorted-CSR binary search WCOJ)",
))
