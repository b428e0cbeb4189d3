"""The host-staging baseline in the port (``graphdb/host_staging.py``) held
against the reference's (``repro.graphdb.host_staging``) and against the
port's resident and ``numpy`` sets, on the CPU: the twin of
``tests/test_residency.py::test_host_staging_baseline_transfers_and_parity``
on ic3 (the same rows, mid-plan downloads only when staged, the same
downloads as the reference's wrapper on the same plan), the residency
sets' 14 queries (``ic`` and ``cbo``) row for row against ``numpy``, the
degree-skew halving of the padded expand block, the blow-up guard, and
``torchops.expand_padded`` against ``jaxops.expand_padded``."""
import numpy as np
import pytest
import torch

from benchmarks import queries as Q
from repro.core.physical import plan_signature as ref_plan_signature
from repro.core.physical_spec import TransferStats as RefTransferStats
from repro.core.physical_spec import get_spec as ref_get_spec
from repro.graphdb import jaxops
from repro.graphdb.engine import Engine as RefEngine
from repro.graphdb.host_staging import \
    HostStagingOperators as RefHostStagingOperators
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical import plan_signature
from repro_torch.core.physical_spec import TransferStats
from repro_torch.graphdb import host_staging, torchops
from repro_torch.graphdb.engine import Engine
from repro_torch.graphdb.host_staging import HostStagingOperators
from repro_torch.graphdb.numpy_backend import NumpyOperators
from repro_torch.graphdb.storage import CSR, export_store, import_store

RESIDENCY_SETS = [("ic", Q.QIC, Q.QIC_PARAMS), ("cbo", Q.QC, {})]
RESIDENCY_QUERIES = [(f"{sn}/{name}", text, params.get(name))
                     for sn, qs, params in RESIDENCY_SETS
                     for name, text in qs.items()]


@pytest.fixture(scope="module")
def port_gopt(small_ldbc):
    return GOpt(import_store(export_store(small_ldbc)), device="cpu")


@pytest.fixture(scope="module")
def staged(port_gopt):
    return HostStagingOperators(port_gopt.spec.operators(port_gopt.store))


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        np.testing.assert_array_equal(np.asarray(a.cols[k]),
                                      np.asarray(b.cols[k]),
                                      err_msg=f"{msg}/{k}")


def _d2h(transfers: dict) -> dict:
    return {k: v for k, v in (transfers or {}).items()
            if k.endswith(":d2h")}


def test_host_staging_baseline_transfers_and_parity(port_gopt, staged,
                                                    gopt_small):
    """ic3: the staged rows equal the resident torch set's and the
    reference wrapper's over its jax set; the staged run downloads
    mid-plan and the resident one does not; on the same plan both
    wrappers make the same downloads (the same padded blocks, slab by
    slab)."""
    text, params = Q.QIC["ic3"], Q.QIC_PARAMS["ic3"]
    opt = port_gopt.optimize(text, params)
    resident, rstats = port_gopt.execute(opt, params=params)
    got, sstats = Engine(port_gopt.store, backend=staged).run(
        opt.logical, opt.physical, params=params)
    _table_eq(got, resident, "staged vs resident")
    assert TransferStats.mid_plan_d2h(sstats.transfers) > 0, \
        sstats.transfers
    assert TransferStats.mid_plan_d2h(rstats.transfers) == 0, \
        rstats.transfers

    ref_opt = gopt_small.optimize(text, params, backend="jax")
    assert plan_signature(opt.physical) == ref_plan_signature(
        ref_opt.physical)
    ref_staged = RefHostStagingOperators(
        ref_get_spec("jax").operators(gopt_small.store))
    want, wstats = RefEngine(gopt_small.store, backend=ref_staged).run(
        ref_opt.logical, ref_opt.physical, params=params)
    _table_eq(got, want, "staged vs the reference's staged")
    assert RefTransferStats.mid_plan_d2h(wstats.transfers) == \
        TransferStats.mid_plan_d2h(sstats.transfers)
    assert _d2h(sstats.transfers) == _d2h(wstats.transfers)


@pytest.mark.parametrize("name,text,params", RESIDENCY_QUERIES,
                         ids=[q[0] for q in RESIDENCY_QUERIES])
def test_residency_queries_match_numpy(port_gopt, staged, name, text,
                                       params):
    opt = port_gopt.optimize(text, params)
    want, _ = port_gopt.execute(opt, backend="numpy", params=params)
    got, stats = Engine(port_gopt.store, backend=staged).run(
        opt.logical, opt.physical, params=params)
    _table_eq(got, want, name)
    assert TransferStats.mid_plan_d2h(stats.transfers) > 0


def _skewed_csr(seed=0):
    """64 rows over 4,096 vertices: one hub of degree 1,500, the rest of
    degree 0-6, sorted rows."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, 64)
    deg[37] = 1500
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(4096, d, replace=False))
                              for d in deg]).astype(np.int64)
    return CSR(indptr, indices, rng.permutation(indices.shape[0]))


def test_expand_halves_a_skewed_block(staged, monkeypatch):
    """Under a budget of 2^11 elements the hub's rows halve down to
    blocks of one padded row group; the flat rows equal the host
    expansion (positions mapped through ``pos``)."""
    monkeypatch.setattr(host_staging, "_EXPAND_ELEMS", 1 << 11)
    csr = _skewed_csr()
    rows = np.random.default_rng(1).integers(0, 64, 200)
    ts = staged.transfer_stats
    mark = ts.mark()
    got = staged.expand(csr, rows)
    want = NumpyOperators(staged.store).expand(csr, rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    slabs = ts.count("d2h", since=mark) // 3
    # 200 rows pad to 256 x 2048 without halving: one block
    assert slabs > 4, slabs


def test_blowup_guard_raises_before_any_upload(staged):
    csr = _skewed_csr()
    ts = staged.transfer_stats
    mark = ts.mark()
    with pytest.raises(RuntimeError, match="blow-up"):
        staged.expand(csr, np.arange(64), max_out=100)
    assert ts.count("h2d", since=mark) == 0
    assert ts.count("d2h", since=mark) == 0


@pytest.mark.parametrize("seed,d_max", [(0, 8), (1, 16), (2, 4), (3, 1)],
                         ids=["whole", "wide", "cut", "one"])
def test_expand_padded_matches_jaxops(seed, d_max):
    """Random CSRs (empty rows included); ``d_max`` below the largest
    degree cuts rows as the reference does."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, 40)
    deg[::7] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, 100, int(indptr[-1])).astype(np.int32)
    rows = rng.integers(0, 40, 33).astype(np.int32)
    want = jaxops.expand_padded(indptr, indices, rows, d_max)
    got = torchops.expand_padded(torch.as_tensor(indptr),
                                 torch.as_tensor(indices),
                                 torch.as_tensor(rows), d_max)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
