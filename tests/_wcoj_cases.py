"""CSRs and probes where a walk down K1's fence index is likely to go wrong,
shared by the CPU tests (``test_torch_wcoj.py``) and the card's
(``test_torch_kernels_gpu.py``).  Numpy only (the delta views are built by
the port's own ``DeltaAdj`` builder), seeded.

Each case is ``(indptr, indices, rows, targets)`` as int32 arrays: rows
sorted, every probe row real.  The probes of a case aim at every key of
every row, at each key's neighbours, at -2 (the fused chains' padding
target), below and above every key and at INT32_MAX.
"""
import numpy as np

I32_MAX = np.iinfo(np.int32).max
# 8^k and 8^k +- 1 for k = 1..4: one node, one level, one more level
POWER_DEGREES = [7, 8, 9, 63, 64, 65, 511, 512, 513, 4095, 4096, 4097]


def _csr(rows):
    deg = np.array([len(r) for r in rows], dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    flat = [np.asarray(r, dtype=np.int64) for r in rows if len(r)]
    indices = (np.concatenate(flat) if flat else np.zeros(0)).astype(np.int32)
    return indptr, indices


def _probes(indptr, indices, rng, per_row=24):
    """Probes of every row: its keys (at most ``per_row`` of them, with the
    first and last), their neighbours, and the edge targets."""
    rows, tgts = [], []
    for r in range(len(indptr) - 1):
        keys = indices[indptr[r]:indptr[r + 1]].astype(np.int64)
        pick = keys
        if len(keys) > per_row:
            pick = np.concatenate([keys[:2], keys[-2:],
                                   rng.choice(keys, per_row - 4)])
        cand = np.concatenate([pick, pick - 1, pick + 1,
                               [-2, -1, 0, I32_MAX - 1, I32_MAX]])
        if len(keys):
            cand = np.concatenate([cand, [keys.min() - 5, keys.max() + 5]])
        cand = np.clip(cand, -2, I32_MAX)
        rows.append(np.full(len(cand), r))
        tgts.append(cand)
    rows, tgts = np.concatenate(rows), np.concatenate(tgts)
    order = rng.permutation(len(rows))
    return rows[order].astype(np.int32), tgts[order].astype(np.int32)


def trouble_cases(seed=0):
    """``{name: (indptr, indices, rows, targets)}``."""
    rng = np.random.default_rng(seed)
    cases = {}

    def add(name, rows, probe_rows=None, probe_targets=None):
        indptr, indices = _csr(rows)
        pr, pt = _probes(indptr, indices, rng)
        if probe_rows is not None:
            pr = np.concatenate([pr, probe_rows]).astype(np.int32)
            pt = np.concatenate([pt, probe_targets]).astype(np.int32)
        cases[name] = (indptr, indices, pr, pt)

    # a value repeated across nodes and levels: the first slot must win
    add("repeated", [[5] * 200, [1] * 30 + [2] * 40 + [3] * 9,
                     [0] * 8 + [7] * 64 + [9] * 65, [4] * 513,
                     list(range(10)) + [10] * 100 + [11]])
    # short rows packed off the node grid, neighbours' keys on either side
    # of the target's (a node's head and tail belong to other rows)
    rows = []
    for i in range(200):
        d = int(rng.integers(1, 12))
        base = 1000 if i % 2 else 0
        rows.append(np.sort(rng.integers(base, base + 40, d)))
    add("shared_nodes", rows)
    # empty rows at the start, between and at the end; row 0 empty, as the
    # fused chains clamp rows outside a type to row 0 with target -2
    rows = [[] for _ in range(5)]
    for i in range(60):
        rows.append([] if i % 3 else np.sort(rng.integers(0, 500, i + 1)))
    rows += [[] for _ in range(4)]
    add("empty_rows", rows, np.zeros(50, np.int32), np.full(50, -2))
    # every 8^k +- 1 degree, once on the node grid and once shifted off it
    rows = []
    for d in POWER_DEGREES:
        rows.append(np.sort(rng.choice(10 * d + 10, d, replace=False)))
        # 1-3 keys: the next row starts off the node grid
        rows.append(np.sort(rng.integers(0, 5, int(rng.integers(1, 4)))))
    add("power_degrees", rows)
    # nnz one short of and past whole nodes, keys over the int32 range
    for nnz in (8 ** 3 - 1, 8 ** 3 + 1, 8 ** 4 + 3):
        cut = np.sort(rng.choice(nnz, 6, replace=False))
        parts = np.split(np.arange(nnz), cut)
        rows = [np.sort(rng.integers(0, I32_MAX - 2, len(p))) for p in parts]
        add(f"nnz_{nnz}", rows)
    # a hub of the smoke's shape: one row of 30,000 among small ones
    rows = [np.sort(rng.choice(10 ** 6, int(rng.integers(0, 20)),
                               replace=False)) for _ in range(30)]
    rows.insert(17, np.sort(rng.choice(10 ** 6, 30_000, replace=False)))
    add("hub", rows)
    # delta views (``graphdb/delta.py::DeltaAdj``): indices padded with
    # zeros past nnz to a power of two, pow2 rows past the real ones, empty
    # with indptr at nnz — the probes aim 0 at every row, padded ones too
    from repro_torch.graphdb.delta import _build_adj
    for name, nnz, hub in (("delta_view_pow2", 1024, 300),
                           ("delta_view_tail", 1025, 300),
                           ("delta_view_short", 77, 0)):
        keys = rng.integers(0, 40, nnz - hub)
        keys = np.concatenate([keys, np.full(hub, 41)])
        nbrs = rng.choice(10 ** 6, nnz, replace=False)
        adj = _build_adj(keys.astype(np.int64), nbrs.astype(np.int64), None)
        assert adj.nnz == nnz and adj.nnz_cap >= nnz and adj.row_cap > \
            adj.n_rows
        indptr = adj.csr.indptr.astype(np.int32)
        indices = adj.csr.indices.astype(np.int32)
        pr, pt = _probes(indptr, indices, rng)
        cases[name] = (indptr, indices, pr, pt)
    # the sharded backend's blocks (``graphdb/partition.py``): one CSR with
    # a hub among every 8^k +- 1 degree cut into 4 row ranges, each block's
    # indices zero-padded past its nnz to the fattest block's pow2 capacity
    # and the last block's rows past the CSR repeating its last offset
    import types
    from repro_torch.graphdb.partition import partition_csr
    rows = [np.sort(rng.choice(10 * d + 10, d, replace=False))
            for d in POWER_DEGREES + [3, 0, 1, 2]]
    rows.insert(5, np.sort(rng.choice(10 ** 6, 20_000, replace=False)))
    indptr, indices = _csr(rows)
    sh = partition_csr(types.SimpleNamespace(indptr=indptr, indices=indices,
                                             pos=None), 4)
    assert sh.rows_per_shard * 4 > len(rows)
    for r in range(4):
        indptr = sh.indptr[r].astype(np.int32)
        indices = sh.indices[r].astype(np.int32)
        assert indptr[-1] < indices.shape[0]
        pr, pt = _probes(indptr, indices, rng)
        cases[f"shard_block_{r}"] = (indptr, indices, pr, pt)
    return cases
