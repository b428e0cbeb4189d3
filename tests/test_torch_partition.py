"""The port's CSR partitioning (``repro_torch.graphdb.partition``), the twin
of the partition tests of ``tests/test_sharded.py`` and of the
``reassemble_csr`` round trips of ``tests/test_delta.py``, plus the port's
blocks held element-equal to the reference's ``partition_csr`` on the same
CSR.  Host numpy on both sides; tolerance: exact equality."""
import types

import numpy as np
import pytest

from repro.graphdb.partition import partition_csr as ref_partition_csr
from repro_torch.graphdb.partition import (CsrShards, partition_csr,
                                           reassemble_csr)
from repro_torch.graphdb.storage import CSR


def _csr(indptr, indices, pos=None):
    return types.SimpleNamespace(indptr=np.asarray(indptr, np.int64),
                                 indices=np.asarray(indices, np.int64),
                                 pos=None if pos is None
                                 else np.asarray(pos, np.int64))


def _random_csr(rng, rows, with_pos):
    deg = rng.integers(0, 6, size=rows)
    indptr = np.zeros(rows + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(deg)
    nnz = int(indptr[-1])
    indices = np.sort(rng.integers(0, 100, size=nnz)).astype(np.int64)
    pos = rng.permutation(nnz).astype(np.int64) if with_pos else None
    return CSR(indptr=indptr, indices=indices, pos=pos)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("with_pos", [False, True])
def test_partition_roundtrip(n_shards, with_pos):
    rng = np.random.default_rng(11)
    n_rows = 13
    deg = rng.integers(0, 7, n_rows)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, 50, int(indptr[-1]))
    pos = rng.permutation(int(indptr[-1])) if with_pos else None
    sh = partition_csr(_csr(indptr, indices, pos), n_shards)
    assert isinstance(sh, CsrShards) and sh.n_shards == n_shards
    ip2, ix2, ps2 = reassemble_csr(sh)
    np.testing.assert_array_equal(ip2, indptr)
    np.testing.assert_array_equal(ix2, indices)
    if with_pos:
        np.testing.assert_array_equal(ps2, pos)
    else:
        assert ps2 is None


def test_partition_ownership_and_bases():
    indptr = [0, 2, 5, 5, 6, 9, 9, 10]          # 7 rows
    sh = partition_csr(_csr(indptr, np.arange(10)), 4)
    assert sh.rows_per_shard == 2
    owners = sh.owner_of(np.arange(7))
    assert owners.tolist() == [0, 0, 1, 1, 2, 2, 3]
    # edge_base[s] is the global flat position of the shard's first edge
    assert sh.edge_base.tolist() == [0, 5, 6, 9]
    # empty / short shards carry inert degree-0 padded rows
    assert sh.indptr[3].tolist()[:2] == [0, 1]
    assert sh.indptr[3].tolist()[2:] == [1]


def test_partition_more_shards_than_rows():
    sh = partition_csr(_csr([0, 2, 5, 5, 6], [10, 12, 3, 7, 9, 12]), 8)
    assert sh.rows_per_shard == 1
    ip2, ix2, _ = reassemble_csr(sh)
    np.testing.assert_array_equal(ip2, [0, 2, 5, 5, 6])
    np.testing.assert_array_equal(ix2, [10, 12, 3, 7, 9, 12])
    # the shards past the rows are empty and inert
    assert not sh.indptr[4:].any()


def test_partition_rejects_zero_shards():
    with pytest.raises(ValueError, match="n_shards"):
        partition_csr(_csr([0, 1], [3]), 0)


@pytest.mark.parametrize("rows,shards", [(1, 1), (5, 2), (17, 4), (40, 8),
                                         (8, 8)])
@pytest.mark.parametrize("with_pos", [False, True])
def test_reassemble_csr_roundtrip_seeded(rows, shards, with_pos):
    """The seeded round trips of ``tests/test_delta.py`` (its property
    test's cases, one parametrised case each)."""
    csr = _random_csr(np.random.default_rng(rows * 10 + shards), rows,
                      with_pos)
    ip, ix, ps = reassemble_csr(partition_csr(csr, shards))
    np.testing.assert_array_equal(ip, csr.indptr)
    np.testing.assert_array_equal(ix, csr.indices)
    if with_pos:
        np.testing.assert_array_equal(ps, csr.pos)
    else:
        assert ps is None


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("with_pos", [False, True])
def test_blocks_equal_the_reference(small_ldbc, shards, with_pos):
    """On a real CSR of the store (KNOWS, IN direction where ``pos`` is
    set), the port's blocks are element-equal to the reference's, with the
    same dtypes and the same ownership."""
    t = next(t for t in small_ldbc.out_csr if t.label == "KNOWS")
    csr = (small_ldbc.in_csr if with_pos else small_ldbc.out_csr)[t]
    assert (csr.pos is not None) == with_pos
    got, want = partition_csr(csr, shards), ref_partition_csr(csr, shards)
    assert (got.n_shards, got.n_rows, got.rows_per_shard) == \
        (want.n_shards, want.n_rows, want.rows_per_shard)
    for name in ("indptr", "indices", "pos", "edge_base"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    ids = np.arange(got.n_rows)
    np.testing.assert_array_equal(got.owner_of(ids), want.owner_of(ids))
