"""The port's operator set (``repro_torch.graphdb.torch_backend``) on the
CPU: its own OperatorSet-v2 conformance suite, and operator-by-operator
parity with the reference numpy and jax sets on the same store and the
same seeded inputs.  Integers compare exactly; AVG to 1e-12 against numpy
(both accumulate in 64 bits) and to 1e-6 relative against jax (whose AVG
is float32)."""
import numpy as np
import pytest
import torch

from repro.core.physical_spec import get_spec as ref_get_spec
from repro.core.schema import EdgeTriple
from repro_torch.core.physical_spec import (dtype_contract_failures,
                                            run_operator_conformance,
                                            validate_operator_set)
from repro_torch.core.schema import EdgeTriple as PortTriple
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import TorchOperators, torch_spec

REFS = ["numpy", "jax"]


@pytest.fixture(scope="module")
def sets(small_ldbc):
    port = import_store(export_store(small_ldbc))
    return {"numpy": ref_get_spec("numpy").operators(small_ldbc),
            "jax": ref_get_spec("jax").operators(small_ldbc),
            "torch": torch_spec("cpu").operators(port),
            "ref_store": small_ldbc, "port_store": port}


def _run(ops, name, *args, **kw):
    """Call ``ops.<name>`` on backend-native copies of host arrays and
    bring every array result home."""
    native = [ops.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
    out = getattr(ops, name)(*native, **kw)
    if isinstance(out, tuple):
        return tuple(_home(ops, o) for o in out)
    return _home(ops, out)


def _home(ops, o):
    if isinstance(o, dict):
        return {k: np.asarray(ops.to_host(v)) for k, v in o.items()}
    return np.asarray(ops.to_host(o))


def _pair(sets, ref, name, *args, **kw):
    return (_run(sets[ref], name, *args, **kw),
            _run(sets["torch"], name, *args, **kw))


# ------------------------------------------------------------- conformance

def test_port_conformance_suite_passes():
    from repro_torch.graphdb.ldbc import generate_motivating
    ops = TorchOperators(generate_motivating(n_person=20, n_product=8,
                                             n_place=4), device="cpu")
    assert run_operator_conformance(ops) == []
    validate_operator_set(ops, conformance=True)
    assert dtype_contract_failures(ops) == []


def test_dtype_contract_catches_an_int_mask():
    """The torch-dtype contract bites: an int 0/1 found mask and int64 id
    columns are flagged."""
    from repro_torch.graphdb.ldbc import generate_motivating

    class Broken(TorchOperators):
        def intersect(self, csr, rows_local, targets):
            found, epos = super().intersect(csr, rows_local, targets)
            return found.to(torch.int32), epos

        def scan(self, lo, hi):
            return super().scan(lo, hi).to(torch.int64)

    ops = Broken(generate_motivating(n_person=20, n_product=8, n_place=4),
                 device="cpu")
    fails = dtype_contract_failures(ops)
    assert any(f.startswith("intersect.found: mask dtype") for f in fails)
    assert any(f.startswith("scan: device dtype torch.int64") for f in fails)


def test_staging_and_delivery_contracts(sets):
    ops = sets["torch"]
    a = ops.asarray(np.array([3, -1, 7], dtype=np.int64))
    assert a.dtype == torch.int32
    with pytest.raises(ValueError):
        ops.asarray(np.array([1 << 40]))
    host = ops.to_host(torch.tensor([5, np.iinfo(np.int32).min],
                                    dtype=torch.int32))
    assert host.dtype == np.int64
    assert host.tolist() == [5, np.iinfo(np.int64).min]
    assert ops.to_host(torch.tensor([0.5], dtype=torch.float32)).dtype \
        == np.float64
    mark = ops.transfer_stats.mark()
    ops.to_host(a)
    assert ops.transfer_stats.count("d2h", since=mark) == 1


def test_blowup_guard_raises_before_allocating(sets):
    ops = sets["torch"]
    csr = sets["port_store"].out_csr[PortTriple("PERSON", "KNOWS", "PERSON")]
    rows = ops.asarray(np.arange(50))
    with pytest.raises(RuntimeError, match="intermediate blow-up"):
        ops.expand(csr, rows, max_out=1)
    keys = ops.asarray(np.zeros(100, dtype=np.int64))
    with pytest.raises(RuntimeError, match="intermediate blow-up"):
        ops.join(keys, keys, max_out=99)


def test_no_cuda_operator_set_without_a_card(small_ldbc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = import_store(export_store(small_ldbc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOperators(port)


# ---------------------------------------------------------------- pattern

@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("direction,label,src,dst", [
    ("out", "KNOWS", "PERSON", "PERSON"),
    ("in", "HASCREATOR", "POST", "PERSON"),
    ("in", "HASTAG", "POST", "TAG"),
])
def test_expand_parity(sets, ref, direction, label, src, dst):
    t = EdgeTriple(src, label, dst)
    pt = PortTriple(src, label, dst)
    st, ps = sets["ref_store"], sets["port_store"]
    keyed = src if direction == "out" else dst
    csr_r = (st.out_csr if direction == "out" else st.in_csr)[t]
    csr_p = (ps.out_csr if direction == "out" else ps.in_csr)[pt]
    rows = np.random.default_rng(1).integers(0, st.v_count[keyed], 300)
    want = _run(sets[ref], "expand", csr_r, rows)
    got = _run(sets["torch"], "expand", csr_p, rows)
    assert got[0].size > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ref", REFS)
def test_scan_and_index_primitives_parity(sets, ref):
    rng = np.random.default_rng(2)
    ids = rng.integers(-5, 50, 400)
    m = rng.random(400) < 0.3
    srt = np.sort(rng.integers(0, 60, 100))
    for name, args, kw in [
            ("scan", (3, 40), {}),
            ("nonzero", (m,), {}),
            ("isin", (ids, [3, 7, 7, -5, 1 << 40]), {}),
            ("searchsorted", (srt, ids), {"side": "left"}),
            ("searchsorted", (srt, ids), {"side": "right"}),
            ("lexsort", ([ids % 3, ids % 5, ids % 2],), {}),
            ("distinct_indices", (ids,), {}),
            ("take", (ids, rng.integers(0, 400, 90)), {}),
            ("mask", (ids, m), {})]:
        if name == "lexsort":
            cols = args[0]
            want = _run(sets[ref], name, [sets[ref].asarray(c)
                                          for c in cols])
            got = _run(sets["torch"], name, [sets["torch"].asarray(c)
                                             for c in cols])
        else:
            want, got = _pair(sets, ref, name, *args, **kw)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("ref", REFS)
def test_property_gather_parity(sets, ref):
    st = sets["ref_store"]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, st.n_vertices, 500)      # mixed vertex types
    for prop in ("id", "creationDate", "length", "name", "firstName"):
        want, got = _pair(sets, ref, "vertex_prop", ids, prop)
        np.testing.assert_array_equal(got, want, err_msg=prop)
    tix = st.triple_index()
    knows = tix[EdgeTriple("PERSON", "KNOWS", "PERSON")]
    likes = tix[EdgeTriple("PERSON", "LIKES", "POST")]
    n_k = st.out_csr[EdgeTriple("PERSON", "KNOWS", "PERSON")].nnz
    n_l = st.out_csr[EdgeTriple("PERSON", "LIKES", "POST")].nnz
    tids = np.where(rng.random(300) < 0.7, knows, likes)
    pos = np.where(tids == knows, rng.integers(0, n_k, 300),
                   rng.integers(0, n_l, 300))
    want, got = _pair(sets, ref, "edge_prop", tids, pos, "creationDate")
    np.testing.assert_array_equal(got, want)
    assert (got == np.iinfo(np.int64).min).any()   # LIKES has no such prop


# --------------------------------------------------------- relational tail

@pytest.mark.parametrize("ref", REFS)
def test_join_parity(sets, ref):
    rng = np.random.default_rng(4)
    lk, rk = rng.integers(0, 40, 300), rng.integers(0, 40, 250)
    (lw, rw), (lg, rg) = _pair(sets, ref, "join", lk, rk)
    assert lg.size > 0
    np.testing.assert_array_equal(lg, lw)
    np.testing.assert_array_equal(rg, rw)


@pytest.mark.parametrize("ref", REFS)
def test_combine_keys_parity(sets, ref):
    """Packed keys differ in value across backends (factorized products vs
    dense ranks) but must group identically and in the same order."""
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 4, 500), rng.integers(-3, 3, 500),
            rng.integers(0, 9, 500)]
    want = _run(sets[ref], "combine_keys",
                [sets[ref].asarray(c) for c in cols])
    got = _run(sets["torch"], "combine_keys",
               [sets["torch"].asarray(c) for c in cols])
    np.testing.assert_array_equal(np.unique(got, return_inverse=True)[1],
                                  np.unique(want, return_inverse=True)[1])


@pytest.mark.parametrize("ref", REFS)
def test_group_reduce_parity(sets, ref):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 37, 1000)
    col = rng.integers(-1000, 100000, 1000)
    aggs = {"c": ("COUNT", col), "s": ("SUM", col), "lo": ("MIN", col),
            "hi": ("MAX", col), "av": ("AVG", col)}

    def go(ops):
        first, out = ops.group_reduce(
            ops.asarray(keys),
            {k: (fn, ops.asarray(c)) for k, (fn, c) in aggs.items()})
        return _home(ops, first), _home(ops, out)

    (fw, ow), (fg, og) = go(sets[ref]), go(sets["torch"])
    np.testing.assert_array_equal(fg, fw)
    for k in ("c", "s", "lo", "hi"):
        np.testing.assert_array_equal(og[k], ow[k], err_msg=k)
    if ref == "numpy":
        np.testing.assert_allclose(og["av"], ow["av"], rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(og["av"], ow["av"], rtol=1e-6)
    assert og["s"].dtype == np.int64 and og["av"].dtype == np.float64
