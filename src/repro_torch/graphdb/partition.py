"""Vertex-cut CSR partitioning for the sharded backend (DESIGN.md §10).

A ``CSR`` keys rows by the *local* id of one vertex type; the sharded
backend splits that row space into ``n_shards`` contiguous ranges — shard
``s`` owns local rows ``[s*rows_per_shard, (s+1)*rows_per_shard)`` — and
each shard carries the sub-CSR of exactly its rows.  Because a triple's two
directions are keyed by different endpoints (OUT by source, IN by
destination), partitioning both directions this way is a *vertex cut*: a
vertex's out-edges live on the shard that owns it as a source while its
in-edges live wherever their destinations land, and an expansion must
route each frontier vertex to its owning shard before any adjacency is
readable.

The partition is host-side numpy and shape-stacked (the reference's layout
for its mesh): every per-shard array is padded to one common capacity so
the blocks stack into ``[n_shards, ...]`` arrays; the port's sharded
backend uploads row ``s`` of each to rank ``s``.
Padding is inert by construction — padded indptr rows repeat the last real
offset (degree 0) and padded ``indices``/``pos`` slots are never addressed
because no real row's range reaches them.

``owner_of`` is the single source of truth for the ownership function; the
sharded backend (``sharded_backend._owned``) recomputes it on the device
with the same integer arithmetic (``local_row // rows_per_shard``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class CsrShards:
    """One CSR partitioned into row-range shards, stacked by shard.

    ``indptr[s]`` is shard ``s``'s *local* indptr (``indptr[s][0] == 0``);
    ``edge_base[s]`` is the global flat position of the shard's first edge,
    so a local flat offset maps back to the CSR's global edge position as
    ``edge_base[s] + local_offset`` — the OUT direction's edge identity.
    For the IN direction the global ``pos`` mapping is partitioned
    alongside ``indices`` (``pos[s][local_offset]`` is already the global
    OUT-order position)."""
    n_shards: int
    n_rows: int                    # keyed rows of the original CSR
    rows_per_shard: int            # contiguous row-range size per shard
    indptr: np.ndarray             # int32[n_shards, rows_per_shard + 1]
    indices: np.ndarray            # int32[n_shards, nnz_cap]
    pos: np.ndarray | None         # int32[n_shards, nnz_cap] | None
    edge_base: np.ndarray          # int32[n_shards] global base edge position

    def owner_of(self, local_rows: np.ndarray) -> np.ndarray:
        """Owning shard per local row id — the ownership function the
        sharded backend mirrors on the device."""
        return np.minimum(np.asarray(local_rows) // self.rows_per_shard,
                          self.n_shards - 1)


def partition_csr(csr, n_shards: int, min_nnz_cap: int = 8) -> CsrShards:
    """Range-partition ``csr``'s keyed rows into ``n_shards`` stacked
    sub-CSRs (see module docstring for the layout contract).

    The per-shard ``nnz`` capacity is the pow2 envelope of the fattest
    shard, so one partition's blocks always stack; empty shards (when
    ``n_rows < n_shards``) carry all-zero indptr rows and are inert.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    n_rows = indptr.shape[0] - 1
    rps = max(1, _ceil_div(n_rows, n_shards))
    shard_nnz = []
    for s in range(n_shards):
        lo = min(s * rps, n_rows)
        hi = min(lo + rps, n_rows)
        shard_nnz.append(int(indptr[hi] - indptr[lo]))
    nnz_cap = _pow2(max(shard_nnz), min_nnz_cap)

    ip = np.zeros((n_shards, rps + 1), dtype=np.int32)
    ix = np.zeros((n_shards, nnz_cap), dtype=np.int32)
    ps = (np.zeros((n_shards, nnz_cap), dtype=np.int32)
          if csr.pos is not None else None)
    base = np.zeros(n_shards, dtype=np.int32)
    for s in range(n_shards):
        lo = min(s * rps, n_rows)
        hi = min(lo + rps, n_rows)
        local = (indptr[lo:hi + 1] - indptr[lo]).astype(np.int32)
        ip[s, :hi - lo + 1] = local
        # padded rows (hi-lo < rps) repeat the last offset: degree 0
        ip[s, hi - lo + 1:] = local[-1] if local.size else 0
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        ix[s, :e1 - e0] = csr.indices[e0:e1]
        if ps is not None:
            ps[s, :e1 - e0] = csr.pos[e0:e1]
        base[s] = e0
    return CsrShards(n_shards=n_shards, n_rows=n_rows, rows_per_shard=rps,
                     indptr=ip, indices=ix, pos=ps, edge_base=base)


def reassemble_csr(shards: CsrShards) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray | None]:
    """Inverse of ``partition_csr`` (tests): rebuild the flat
    ``(indptr, indices, pos)`` from the stacked shards."""
    n = shards.n_rows
    rps = shards.rows_per_shard
    indptr = [0]
    indices, pos = [], []
    for s in range(shards.n_shards):
        lo = min(s * rps, n)
        hi = min(lo + rps, n)
        local = shards.indptr[s]
        for r in range(hi - lo):
            indptr.append(indptr[-1] + int(local[r + 1] - local[r]))
        e1 = int(local[hi - lo]) if hi > lo else 0
        indices.append(shards.indices[s, :e1])
        if shards.pos is not None:
            pos.append(shards.pos[s, :e1])
    return (np.asarray(indptr, dtype=np.int64),
            np.concatenate(indices) if indices else np.zeros(0, np.int64),
            (np.concatenate(pos) if pos else np.zeros(0, np.int64))
            if shards.pos is not None else None)
