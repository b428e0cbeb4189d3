"""The port's delta store (``repro_torch.graphdb.delta``) held against the
reference's (``repro.graphdb.delta``), the twin of ``tests/test_delta.py``;
its sharded cases run here on one rank (``sharded[1,cpu]``) and, at two
ranks, in ``test_torch_sharded.py``'s gloo world.

Both sides start from one store (the reference's generator, carried across
with ``import_store(export_store(...))``) and take the same seeded mutation
script.  Tolerance: exact equality — snapshot views array-equal (``keys``,
``indptr``, ``indices``, ``pos``), query rows identical and in the same
order (the port on ``torch[cpu]`` and on its ``numpy`` spec, the reference
on ``numpy``, and on ``jax`` for a few), compacted stores array-equal to
the reference's compacted store and to a from-scratch build.  Also: the
overlay property gathers (extension ids and overlay edge positions, which
``index_select`` would refuse unclamped), chains declining on a delta and
recovering after compaction, zero mid-plan device->host copies, snapshot
isolation against deep-copy oracles, stale snapshots, stats epochs, the
server's update stream, and the device caches letting go of collected
views and of a compacted-away base."""
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from benchmarks import queries as Q
from repro.core.gopt import GOpt as RefGOpt
from repro.graphdb.delta import MutableGraphStore as RefMutable
from repro.graphdb.ldbc import generate_ldbc, generate_motivating
from repro_torch.core import errors as port_errors
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical_spec import TransferStats
from repro_torch.graphdb import delta as port_delta
from repro_torch.graphdb.delta import (MutableGraphStore, StaleSnapshotError,
                                       _build_adj)
from repro_torch.graphdb.storage import (build_store, export_store,
                                         import_store)
from repro_torch.graphdb.torch_backend import torch_spec

import _sharded_world

QK = """MATCH (a:PERSON)-[:knows]->(b:PERSON)
RETURN a.id AS aid, b.id AS bid ORDER BY aid, bid"""
Q2HOP = """MATCH (a:PERSON)-[:knows]->(b:PERSON)-[:knows]->(c:PERSON)
RETURN a.id AS aid, c.id AS cid, count(b) AS n ORDER BY aid, cid"""
QPROPS = """MATCH (a:PERSON)-[:purchases]->(p:PRODUCT)
RETURN a.id AS aid, p.id AS pid ORDER BY aid, pid"""
QTRI = """MATCH (a:PERSON)-[:knows]->(b:PERSON), (a)-[:knows]->(c:PERSON),
(b)-[:knows]->(c) RETURN a.id AS aid, b.id AS bid, c.id AS cid
ORDER BY aid, bid, cid"""
QEDGE = ("MATCH (a:PERSON)-[k:KNOWS]->(b:PERSON) "
         "RETURN a.id AS aid, b.id AS bid, k.creationDate AS d "
         "ORDER BY aid, bid")
I64_MIN = np.iinfo(np.int64).min
SEEDS = [0, 1, 2, 3]


def _motivating():
    return generate_motivating(n_person=50, n_product=20, n_place=8)


def _pair(ref_base):
    """The reference's mutable store and the port's over the same base."""
    return (RefMutable(ref_base),
            MutableGraphStore(import_store(export_store(ref_base))))


def _triple(base, label):
    t = next(t for t in base.out_csr if t.label == label)
    return (t.src, t.label, t.dst)


def _script(base, seed: int, n: int = 80) -> list:
    """A seeded mix of vertex and edge inserts and deletes over every
    triple of ``base``: ``[(method, args), ...]``.  Inserts carry the
    schema's integer properties; some ops aim at dead or missing endpoints
    and fail the same way on both sides."""
    rng = np.random.default_rng(seed)
    triples = [(t.src, t.label, t.dst) for t in base.out_csr]
    types = sorted(base.v_offset)
    ext = {t: [] for t in types}
    slot = 0
    out = []

    def pick(vtype):
        lo, hi = base.type_range(vtype)
        if ext[vtype] and rng.random() < 0.4:
            return int(rng.choice(ext[vtype]))
        return int(rng.integers(lo, hi))

    for step in range(n):
        k = int(rng.integers(0, 10))
        if k < 2:
            vt = types[int(rng.integers(0, len(types)))]
            props = {p: 100_000 + step for p, ty in
                     base.schema.vertex_props.get(vt, {}).items()
                     if ty == "int"}
            out.append(("insert_vertex", (vt, props)))
            ext[vt].append(base.n_vertices + slot)
            slot += 1
        elif k < 7:
            s, lab, d = triples[int(rng.integers(0, len(triples)))]
            props = {p: 7_000 + step for p, ty in
                     base.schema.edge_props.get(lab, {}).items()
                     if ty == "int"}
            out.append(("insert_edge", ((s, lab, d), pick(s), pick(d),
                                        props or None)))
        elif k < 9:
            t = list(base.out_csr)[int(rng.integers(0, len(triples)))]
            csr = base.out_csr[t]
            lo, _ = base.type_range(t.src)
            row = int(rng.integers(0, csr.indptr.shape[0] - 1))
            if csr.indptr[row + 1] > csr.indptr[row]:
                dst = int(csr.indices[csr.indptr[row]])
            else:
                dst = pick(t.dst)
            out.append(("delete_edge", ((t.src, t.label, t.dst), lo + row,
                                        dst)))
        else:
            vt = types[int(rng.integers(0, len(types)))]
            out.append(("delete_vertex", (pick(vt),)))
    return out


def _apply(ms, script) -> list:
    res = []
    for name, args in script:
        try:
            res.append(getattr(ms, name)(*args))
        except (KeyError, ValueError) as exc:
            res.append(type(exc).__name__)
    return res


def _mixed(seed: int = 0, base=None):
    """Both sides after the same script (the results must agree)."""
    base = base if base is not None else _motivating()
    ref, port = _pair(base)
    script = _script(base, seed)
    assert _apply(ref, script) == _apply(port, script)
    return base, ref, port


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        x, y = np.asarray(a.cols[k]), np.asarray(b.cols[k])
        assert x.dtype == y.dtype, f"{msg}/{k}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}/{k}")


def _port(store, backend):
    if backend == "cpu":
        return GOpt(store, device="cpu")
    if backend == "sharded":
        return GOpt(store, backend="sharded", devices=1, device="cpu")
    return GOpt(store, backend=backend)


def _key(t):
    return (t.src, t.label, t.dst)


# ------------------------------------------------------------ snapshot views

@pytest.mark.parametrize("seed", SEEDS)
def test_snapshot_views_equal_reference(seed):
    """The same script leaves array-equal insert and tombstone views, the
    same extension and dead vertex sets and the same version."""
    _, ref, port = _mixed(seed)
    rs, ps = ref.snapshot(), port.snapshot()
    assert rs.version == ps.version and rs.is_empty == ps.is_empty
    for attr in ("ins", "dels"):
        rv, pv = getattr(rs, attr), getattr(ps, attr)
        assert {(_key(t), k) for t, k in rv} == {(_key(t), k) for t, k in pv}
        for (t, kind), a in rv.items():
            b = next(v for (u, k), v in pv.items()
                     if _key(u) == _key(t) and k == kind)
            assert (a.n_rows, a.nnz) == (b.n_rows, b.nnz)
            for name, x, y in (("keys", a.keys, b.keys),
                               ("indptr", a.csr.indptr, b.csr.indptr),
                               ("indices", a.csr.indices, b.csr.indices),
                               ("pos", a.csr.pos, b.csr.pos)):
                if x is None or y is None:
                    assert x is None and y is None, name
                    continue
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
    for attr in ("ext", "dead"):
        rv, pv = getattr(rs, attr), getattr(ps, attr)
        assert set(rv) == set(pv)
        for t in rv:
            np.testing.assert_array_equal(rv[t], pv[t])
    assert ref.delta_info() == port.delta_info()


# ------------------------------------------------------- overlay read parity

@pytest.mark.parametrize("query", [QK, Q2HOP, QPROPS, QTRI],
                         ids=["knows", "two_hop", "purchases", "triangle"])
@pytest.mark.parametrize("backend", ["cpu", "numpy", "sharded"])
def test_overlay_rows_equal_reference(backend, query):
    """With inserts and tombstones live, the port (``torch[cpu]`` and its
    ``numpy`` spec) answers row-identically to the reference numpy
    backend over the reference's store."""
    _, ref, port = _mixed(0)
    want, _ = RefGOpt(ref, backend="numpy").run(query)
    got, _ = _port(port, backend).run(query)
    assert want.nrows > 0
    _table_eq(got, want, backend)


@pytest.mark.parametrize("query", [QK, QTRI], ids=["knows", "triangle"])
def test_overlay_rows_equal_reference_jax(query):
    _, ref, port = _mixed(1)
    want, _ = RefGOpt(ref, backend="jax").run(query)
    got, _ = GOpt(port, device="cpu").run(query)
    _table_eq(got, want)


@pytest.mark.parametrize("backend", ["cpu", "numpy", "sharded"])
def test_overlay_parity_vs_frozen_oracle(backend):
    """The reference's acceptance case: with the reference's insert/delete
    mix live in the overlay, every spec answers row-identically to the
    port's numpy spec on a frozen deep copy."""
    pairs = _sharded_world.overlay_parity(lambda ms: _port(ms, backend))
    for got, want in pairs:
        assert got == want and got


@pytest.mark.parametrize("backend", ["cpu", "numpy", "sharded"])
def test_snapshot_isolation_under_writes(backend):
    """A query pinned at snapshot S answers as-of S while writes land: equal
    to the port's numpy spec on a deep copy taken at S, and to the
    reference on its own copy taken at S."""
    base = _motivating()
    ref, port = _pair(base)
    kt = _triple(base, "KNOWS")
    csr = base.out_csr[next(t for t in base.out_csr if t.label == "KNOWS")]
    off = base.v_offset["PERSON"]
    gopt = _port(port, backend)
    snaps = []
    for i in range(4):
        snaps.append((gopt.snapshot(), copy.deepcopy(port),
                      copy.deepcopy(ref)))
        for ms in (ref, port):
            gid = ms.insert_vertex("PERSON", {"id": 8800 + i})
            ms.insert_edge(kt, off + i, gid)
            row = int(np.argsort(np.diff(csr.indptr), kind="stable")[-(i + 1)])
            if csr.indptr[row] < csr.indptr[row + 1]:
                ms.delete_edge(kt, off + row,
                               int(csr.indices[csr.indptr[row]]))
            if i == 2:
                ms.delete_vertex(gid)
    snaps.append((gopt.snapshot(), copy.deepcopy(port), copy.deepcopy(ref)))
    for snap, frozen, rfrozen in snaps:
        got, _ = gopt.run(QK, snapshot=snap)
        oracle, _ = GOpt(frozen, backend="numpy").run(QK)
        want, _ = RefGOpt(rfrozen, backend="numpy").run(QK)
        _table_eq(got, oracle, f"v{snap.version} vs deep copy")
        _table_eq(got, want, f"v{snap.version} vs reference")


def test_chain_declines_on_delta_and_recovers_after_compaction():
    """Fused chains decline (``chain_delta``) only when the snapshot can
    change a hop, keep rows equal to the reference, and come back after
    compaction."""
    base = _motivating()
    ref, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    for m in (ref, ms):
        m.insert_vertex("PERSON", {"id": 9100})
    assert not ms.snapshot().affects_chain([kt])
    gopt = GOpt(ms, device="cpu")
    o = gopt.optimize(Q2HOP, cbo=False)
    gopt.execute(o)                                    # measures the chain
    _, stats = gopt.execute(o)
    assert "chain_delta" not in (stats.fallbacks or {})
    assert stats.kernels.get("dispatch:fused_chain", 0) == 1
    off = base.v_offset["PERSON"]
    for m in (ref, ms):
        m.insert_edge(kt, off, off + 7)
    assert ms.snapshot().affects_chain(
        [next(t for t in ms.base.out_csr if t.label == "KNOWS")])
    got, stats2 = gopt.execute(o)
    assert stats2.fallbacks.get("chain_delta", 0) >= 1
    assert stats2.kernels.get("dispatch:fused_chain", 0) == 0
    want, _ = RefGOpt(ref, backend="numpy").run(Q2HOP)
    _table_eq(got, want)
    for m in (ref, ms):
        m.delete_vertex(m.insert_vertex("PERSON"))
    pt = next(t for t in ms.base.out_csr if t.label == "PURCHASES")
    assert ms.snapshot().affects_chain([pt])
    gopt.compact()
    ref.compact()
    o3 = gopt.optimize(Q2HOP, cbo=False)
    gopt.execute(o3)
    got3, stats3 = gopt.execute(o3)
    assert "chain_delta" not in (stats3.fallbacks or {})
    assert stats3.kernels.get("dispatch:fused_chain", 0) == 1
    want3, _ = RefGOpt(ref, backend="numpy").run(Q2HOP)
    _table_eq(got3, want3)


@pytest.mark.parametrize("query", [Q2HOP, QTRI], ids=["two_hop", "triangle"])
def test_mid_plan_d2h_zero_with_overlay(query):
    """Residency: with an overlay (insert and tombstone views probed by
    the kernel's plain version) nothing crosses to the host mid-plan."""
    _, _, port = _mixed(2)
    tbl, stats = GOpt(port, device="cpu").run(query)
    assert tbl.nrows > 0
    assert TransferStats.mid_plan_d2h(stats.transfers) == 0, stats.transfers
    if query is QTRI:
        assert stats.kernels.get("dispatch:intersect", 0) >= 3


# ------------------------------------------------------- overlay properties

def test_overlay_props_equal_reference():
    """``vertex_prop`` on extension ids and ``edge_prop`` on overlay
    positions: the torch set's gathers clamp each side before selecting,
    and equal the reference's host gathers and its jax set's."""
    from repro.core.physical_spec import get_spec as ref_get_spec
    base = _motivating()
    ref, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    off = base.v_offset["PERSON"]
    for m in (ref, ms):
        g1 = m.insert_vertex("PERSON", {"id": 9200, "age": 33})
        g2 = m.insert_vertex("PERSON", {"id": 9201})
        m.insert_edge(kt, g1, g2, {"weight": 7})
        m.insert_edge(kt, off, g1)
        m.insert_vertex("PRODUCT", {"id": 9300})
    ids = np.array([g1, g2, off, off + 3, base.n_vertices - 1,
                    ms.id_space - 1], dtype=np.int64)
    ops = torch_spec("cpu").operators(ms)
    jops = ref_get_spec("jax").operators(ref)
    for prop in ("id", "age", "name"):
        want = ref.vertex_prop(ids, prop)
        got = ops.to_host(ops.vertex_prop(ops.asarray(ids), prop))
        np.testing.assert_array_equal(got, want, err_msg=prop)
        np.testing.assert_array_equal(
            got, jops.to_host(jops.vertex_prop(jops.asarray(ids), prop)))
    assert got.dtype == np.int64
    nbase = ms.base.n_edges
    tix = ms.triple_index()[next(t for t in ms.base.out_csr
                                 if t.label == "KNOWS")]
    tids = np.full(5, tix, dtype=np.int64)
    pos = np.array([0, 3, nbase, nbase + 1, 1], dtype=np.int64)
    for prop in ("weight", "id"):
        want = ref.edge_prop(tids, pos, prop)
        got = ops.to_host(ops.edge_prop(ops.asarray(tids), ops.asarray(pos),
                                        prop))
        np.testing.assert_array_equal(got, want, err_msg=prop)
        if prop == "weight":
            assert got[2] == 7 and got[0] == I64_MIN
    assert ref.vertex_prop(ids, "age")[0] == 33
    assert ref.vertex_prop(ids, "age")[1] == I64_MIN
    # the unclamped gather is what the clamp guards against
    with pytest.raises((IndexError, RuntimeError)):
        ops.take(ops._vprop_dev("id"), ops.asarray(ids))


def test_extension_vertex_property_predicate_as_the_reference():
    """The smallest input of the fault the overlay gathers repair: one
    PERSON inserted with ``id`` 9200, then a predicate on it.  Gathering
    from the base column alone read the missing value (no row)."""
    ref, ms = _pair(_motivating())
    for m in (ref, ms):
        m.insert_vertex("PERSON", {"id": 9200})
    q = "MATCH (a:PERSON) WHERE a.id = 9200 RETURN a.id AS aid"
    want, _ = RefGOpt(ref, backend="numpy").run(q)
    got, _ = GOpt(ms, device="cpu").run(q)
    assert want.nrows == 1
    _table_eq(got, want)


@pytest.mark.parametrize("backend", ["cpu", "numpy"])
def test_overlay_edge_property_rows_equal_reference(backend):
    """KNOWS edges inserted with ``creationDate`` (and base edges keeping
    theirs) read back through a query as the reference reads them."""
    base = generate_ldbc(sf=0.02, seed=3)
    ref, ms = _pair(base)
    script = _script(base, 5, n=120)
    assert _apply(ref, script) == _apply(ms, script)
    assert ms.overlay_edge_slots > 0
    want, _ = RefGOpt(ref, backend="numpy").run(QEDGE)
    got, _ = _port(ms, backend).run(QEDGE)
    _table_eq(got, want)


# --------------------------------------------------------------- compaction

def _scratch_oracle(base, ms):
    """A from-scratch ``build_store`` over the same logical graph, in the
    canonical renumbering (the reference test's oracle, on the port)."""
    bv = base.n_vertices
    old2new = np.full(ms.id_space, -1, dtype=np.int64)
    counts, vprops, ext_by_type = {}, {}, {}
    for s, t in enumerate(ms._ext_type):
        if ms._ext_alive[s]:
            ext_by_type.setdefault(t, []).append(s)
    for t in base.schema.vertex_types:
        lo, hi = base.type_range(t)
        keep = [g for g in range(lo, hi) if g not in ms._dead_base]
        exts = ext_by_type.get(t, [])
        for j, g in enumerate(keep + [bv + s for s in exts]):
            old2new[g] = j
        counts[t] = len(keep) + len(exts)
        props = set(base.v_props.get(t, {}))
        props |= {p for p, slots in ms._ext_props.items()
                  if any(s in slots for s in exts)}
        cols = {}
        for p in props:
            col = np.full(counts[t], I64_MIN, dtype=np.int64)
            bcol = base.v_props.get(t, {}).get(p)
            if bcol is not None:
                col[:len(keep)] = bcol[np.asarray(keep, np.int64) - lo]
            for j, s in enumerate(exts):
                if s in ms._ext_props.get(p, {}):
                    col[len(keep) + j] = ms._ext_props[p][s]
            cols[p] = col
        if cols:
            vprops[t] = cols
    edges, eprops = {}, {}
    for t, csr in base.out_csr.items():
        lo, _ = base.type_range(t.src)
        deg = np.diff(csr.indptr)
        gsrc = np.repeat(np.arange(deg.shape[0], dtype=np.int64) + lo, deg)
        gdst = csr.indices
        epos = np.arange(gdst.shape[0], dtype=np.int64)
        dset = ms._dels.get(t) or set()
        keep = np.array([old2new[s] >= 0 and old2new[d] >= 0
                         and (int(s), int(d)) not in dset
                         for s, d in zip(gsrc, gdst)], dtype=bool)
        gsrc, gdst, epos = gsrc[keep], gdst[keep], epos[keep]
        ins = [(k, v) for k, v in (ms._ins.get(t) or {}).items()
               if old2new[k[0]] >= 0 and old2new[k[1]] >= 0]
        all_src = old2new[np.concatenate(
            [gsrc, np.array([k[0] for k, _ in ins], np.int64)])]
        all_dst = old2new[np.concatenate(
            [gdst, np.array([k[1] for k, _ in ins], np.int64)])]
        edges[t] = (all_src.astype(np.int64), all_dst.astype(np.int64))
        props = set(base.e_props.get(t, {}))
        props |= {p for p, slots in ms._eprops_over.items()
                  if any(v in slots for _, v in ins)}
        cols = {}
        for p in props:
            col = np.full(all_src.shape[0], I64_MIN, dtype=np.int64)
            bcol = base.e_props.get(t, {}).get(p)
            if bcol is not None:
                col[:gsrc.shape[0]] = bcol[epos]
            for j, (_, slot) in enumerate(ins):
                if slot in ms._eprops_over.get(p, {}):
                    col[gsrc.shape[0] + j] = ms._eprops_over[p][slot]
            cols[p] = col
        if cols:
            eprops[t] = cols
    return build_store(base.schema, counts, edges, v_props=vprops,
                       e_props=eprops, str_vocab=base.str_vocab)


def _assert_stores_identical(a, b):
    assert a.v_count == b.v_count
    assert {_key(t) for t in a.out_csr} == {_key(t) for t in b.out_csr}
    bt = {_key(t): t for t in b.out_csr}
    for t in a.out_csr:
        u = bt[_key(t)]
        for attr in ("out_csr", "in_csr"):
            ca, cb = getattr(a, attr)[t], getattr(b, attr)[u]
            for name in ("indptr", "indices", "pos"):
                x, y = getattr(ca, name), getattr(cb, name)
                if x is None or y is None:
                    assert x is None and y is None, (t, attr, name)
                    continue
                np.testing.assert_array_equal(x, y, err_msg=f"{t}/{name}")
    assert set(a.v_props) == set(b.v_props)
    for t in a.v_props:
        assert set(a.v_props[t]) == set(b.v_props[t])
        for p in a.v_props[t]:
            np.testing.assert_array_equal(a.v_props[t][p], b.v_props[t][p])
    assert {_key(t) for t in a.e_props} == {_key(t) for t in b.e_props}
    be = {_key(t): v for t, v in b.e_props.items()}
    for t, cols in a.e_props.items():
        assert set(cols) == set(be[_key(t)])
        for p in cols:
            np.testing.assert_array_equal(cols[p], be[_key(t)][p])


@pytest.mark.parametrize("seed", SEEDS)
def test_compaction_equals_reference_and_scratch(seed):
    """The compacted store is array-equal to the reference's compacted
    store and to a from-scratch build; the event dicts agree (but for
    wall time), and rows equal the pre-compaction overlay answer."""
    base, ref, port = _mixed(seed)
    pre, _ = GOpt(port, device="cpu").run(QK)
    oracle = _scratch_oracle(port.base, port)
    er, ep = ref.compact(), port.compact()
    for ev in (er, ep):     # wall time, and snapshots the runs left alive
        ev.pop("wall_s")
        ev.pop("retired_snapshots")
    assert er == ep
    _assert_stores_identical(port.base, ref.base)
    _assert_stores_identical(port.base, oracle)
    post, _ = GOpt(port, device="cpu").run(QK)
    _table_eq(post, pre)


_APPENDIX = ([(n, t, None) for n, t in list(Q.QT.items()) + list(Q.QC.items())]
             + [(n, t, Q.QR_PARAMS.get(n)) for n, t in Q.QR.items()]
             + [(n, t, Q.QIC_PARAMS.get(n)) for n, t in Q.QIC.items()])


@pytest.fixture(scope="module")
def ldbc_pair():
    """An LDBC store mutated by one script on both sides, and the same
    pair compacted (the port's compacted store beside its scratch
    oracle)."""
    base = generate_ldbc(sf=0.05, seed=7)
    script = _script(base, 11, n=200)
    live_ref, live = _pair(base)
    comp_ref, comp = _pair(base)
    for ms in (live_ref, live, comp_ref, comp):
        _apply(ms, script)
    oracle = _scratch_oracle(comp.base, comp)
    comp_ref.compact()
    comp.compact()
    return {"live": (RefGOpt(live_ref, backend="numpy"),
                     GOpt(live, device="cpu")),
            "compacted": (RefGOpt(comp_ref, backend="numpy"),
                          GOpt(comp, device="cpu"),
                          GOpt(oracle, device="cpu"))}


@pytest.mark.parametrize("name,text,params", _APPENDIX,
                         ids=[q[0] for q in _APPENDIX])
def test_appendix_rows_with_overlay_and_after_compaction(ldbc_pair, name,
                                                         text, params):
    """Every Appendix-A query over the live overlay, and over the compacted
    store, equals the reference's rows; the compacted store answers as a
    from-scratch build over the same graph does; queries that return no
    raw vertex id answer the same before and after compaction."""
    rg, pg = ldbc_pair["live"]
    want, _ = rg.run(text, params)
    got, _ = pg.run(text, params)
    _table_eq(got, want, "overlay")
    crg, cpg, og = ldbc_pair["compacted"]
    cwant, _ = crg.run(text, params)
    cgot, _ = cpg.run(text, params)
    _table_eq(cgot, cwant, "compacted")
    _table_eq(cgot, og.run(text, params)[0], "scratch")
    if name not in Q.QIC:
        _table_eq(cgot, got, "across compaction")


def test_stale_snapshot_raises_after_compaction():
    """The delta module's error is the one the engine raises and catches
    (``core/errors.py``), not a second class."""
    assert StaleSnapshotError is port_errors.StaleSnapshotError
    assert port_delta.StaleSnapshotError is port_errors.StaleSnapshotError
    _, ms = _pair(_motivating())
    ms.insert_vertex("PERSON", {"id": 9999})
    gopt = GOpt(ms, device="cpu")
    snap = gopt.snapshot()
    ms.compact()
    assert snap.retired
    with pytest.raises(StaleSnapshotError):
        gopt.run(QK, snapshot=snap)


def test_stats_epoch_recost_with_overlay():
    """Overlay edges count toward triple frequencies as in the reference,
    and ``GOpt.compact`` bumps the stats epoch."""
    base = _motivating()
    ref, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    gopt, rgopt = GOpt(ms, device="cpu"), RefGOpt(ref)
    tk = next(t for t in ms.base.out_csr if t.label == "KNOWS")
    rtk = next(t for t in ref.base.out_csr if t.label == "KNOWS")
    f0 = gopt.stats.triple_freq(tk)
    assert f0 == rgopt.stats.triple_freq(rtk)
    off = base.v_offset["PERSON"]
    added = [sum(m.insert_edge(kt, off + i, off + ((i + 25) % 50))
                 for i in range(10)) for m in (ref, ms)]
    assert added[0] == added[1] > 0
    assert gopt.stats.triple_freq(tk) == rgopt.stats.triple_freq(rtk) \
        == f0 + added[1]
    gopt.prepare(QK)
    info0 = gopt.plan_cache_info()
    ev = gopt.compact()
    assert ev["merged_edges"] == added[1]
    info1 = gopt.plan_cache_info()
    assert info1["epoch"] == info0["epoch"] + 1 and info1["plans"] == 0
    tk2 = next(t for t in ms.base.out_csr if t.label == "KNOWS")
    assert gopt.stats.triple_freq(tk2) == f0 + added[1]
    ref.compact()
    assert gopt.glogue.freq == RefGOpt(ref).glogue.freq


def test_delta_adj_pow2_capacity_plateau():
    shapes = set()
    for n in range(1, 200):
        keys = np.arange(n, dtype=np.int64) % 37
        adj = _build_adj(keys, np.arange(n, dtype=np.int64), None)
        assert adj.row_cap & (adj.row_cap - 1) == 0
        assert adj.nnz_cap & (adj.nnz_cap - 1) == 0
        assert (adj.csr.indices[adj.nnz:] == 0).all()
        assert (adj.keys[adj.n_rows:] == port_delta.SENTINEL_KEY).all()
        shapes.add((adj.row_cap, adj.nnz_cap))
    assert len(shapes) <= 16, shapes


def test_delta_views_cached_until_touched():
    base = _motivating()
    _, ms = _pair(base)
    kt, pt = _triple(base, "KNOWS"), _triple(base, "PURCHASES")
    off = base.v_offset["PERSON"]
    ms.insert_edge(kt, off, off + 9)
    s1 = ms.snapshot()
    ms.insert_edge(pt, off, base.v_offset["PRODUCT"])
    s2 = ms.snapshot()
    tk = next(t for t in ms.base.out_csr if t.label == "KNOWS")
    assert s2.ins[(tk, "out")] is s1.ins[(tk, "out")]
    ms.insert_edge(kt, off + 1, off + 8)
    assert ms.snapshot().ins[(tk, "out")] is not s1.ins[(tk, "out")]


# --------------------------------------------------------- the device caches

def test_device_cache_drops_collected_views():
    """The torch set caches a view's device twin (and its K1 index) while
    the view lives, and drops the entry once the view is collected; a
    live entry is reused."""
    base = _motivating()
    _, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    off = base.v_offset["PERSON"]
    gopt = GOpt(ms, device="cpu")
    ops = gopt.spec.operators(ms)
    ms.insert_edge(kt, off, off + 9)
    ms.delete_edge(kt, off, int(base.out_csr[next(
        t for t in base.out_csr if t.label == "KNOWS")].indices[0]))
    gopt.run(QTRI)
    snap = ms.snapshot()
    views = list(snap.ins.values()) + list(snap.dels.values())
    probed = [v for v in views if id(v.csr) in ops._dev]
    assert probed
    assert any(ops._dev[id(v.csr)][1][3] is not None for v in probed)
    first = ops._csr_dev(probed[0].csr)
    assert ops._csr_dev(probed[0].csr)[1] is first[1]
    old = [weakref.ref(v.csr) for v in probed]
    n_cached = len(ops._dev)
    del first, views, probed, snap
    ms.insert_edge(kt, off + 1, off + 8)                # new views
    ms.delete_edge(kt, off + 1, off + 8)
    gopt.run(QTRI)
    gc.collect()
    assert all(r() is None for r in old)
    # every entry left belongs to a live CSR: the old views' went with them
    assert all(ent[0]() is not None for ent in ops._dev.values())
    assert len(ops._dev) <= n_cached
    snap = ms.snapshot()
    assert any(id(v.csr) in ops._dev for v in
               list(snap.ins.values()) + list(snap.dels.values()))


def test_compaction_releases_the_old_base():
    """After ``compact()`` the torch set keeps no device twin of the old
    base's CSRs, no property column of the old epoch, and no chain handle
    over the old CSRs."""
    base = _motivating()
    _, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    gopt = GOpt(ms, device="cpu")
    ops = gopt.spec.operators(ms)
    o = gopt.optimize(Q2HOP, cbo=False)
    gopt.execute(o)
    gopt.execute(o)
    gopt.run(QPROPS)
    ms.insert_vertex("PERSON", {"id": 1})
    ms.insert_edge(kt, base.v_offset["PERSON"], base.v_offset["PERSON"] + 3)
    gopt.run(QK)
    old = [weakref.ref(c) for c in list(ms.base.out_csr.values())
           + list(ms.base.in_csr.values())]
    old_ids = {id(r()) for r in old}
    assert old_ids & set(ops._dev)
    assert ops._chains and ops._props
    del o
    gopt.compact()
    gc.collect()
    assert all(r() is None for r in old)
    assert all(ent[0]() is not None for ent in ops._dev.values())
    assert all(k[2] == ms.compaction_epoch for k in ops._props)
    tbl, _ = gopt.run(QK)
    assert tbl.nrows > 0


# ------------------------------------------------- serving: the update stream

def test_serve_update_stream_snapshot_parity():
    """Writes ride the admission path; every read answers as-of its
    admission snapshot, as the reference's server does on the same
    stream."""
    base = _motivating()
    ref, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    out = []
    for store, G, kw in ((ref, RefGOpt, {"backend": "numpy"}),
                         (ms, GOpt, {"device": "cpu"})):
        srv = G(store, **kw).serve(max_wave=8)
        reads, oracle = [srv.submit(QK)], []
        srv.drain()
        for i in range(5):
            rq = srv.submit(QK)
            oracle.append(copy.deepcopy(store))
            reads.append(rq)
            w = srv.submit_update("insert_vertex", "PERSON",
                                  {"id": 7700 + i})
            srv.drain()
            assert w.status == "done"
            srv.submit_update("insert_edge", kt, base.v_offset["PERSON"] + i,
                              w.result)
            srv.drain()
        reads.append(srv.submit(QK))
        srv.drain()
        srv.close()
        assert srv.stats.writes == 10
        if G is GOpt:
            for rq, frozen in zip(reads[1:], oracle):
                _table_eq(rq.table, GOpt(frozen, backend="numpy").run(QK)[0])
        out.append(reads)
    for a, b in zip(*out):
        assert a.status == b.status == "done"
        _table_eq(b.table, a.table)
    assert out[1][-1].table.nrows == out[1][0].table.nrows + 5


def test_serve_stats_epoch_mid_stream():
    base = _motivating()
    _, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    gopt = GOpt(ms, device="cpu")
    srv = gopt.serve(max_wave=4)
    ref_rows, _ = GOpt(copy.deepcopy(ms), backend="numpy").run(QK)
    reqs = [srv.submit(QK) for _ in range(4)]
    srv.drain()
    cbo0 = gopt.compile_counters["cbo"]
    off = base.v_offset["PERSON"]
    for i in range(8):
        ms.insert_edge(kt, off + i, off + ((i + 31) % 50))
    epoch0 = gopt.plan_cache_info()["epoch"]
    gopt.refresh_stats()
    info = gopt.plan_cache_info()
    assert info["epoch"] == epoch0 + 1 and info["plans"] == 0
    ref_rows2, _ = GOpt(copy.deepcopy(ms), backend="numpy").run(QK)
    reqs2 = [srv.submit(QK) for _ in range(4)]
    srv.drain()
    srv.close()
    for r in reqs:
        assert r.status == "done"
        _table_eq(r.table, ref_rows)
    for r in reqs2:
        assert r.status == "done"
        _table_eq(r.table, ref_rows2)
    assert gopt.compile_counters["cbo"] == cbo0 + 1
    assert gopt.plan_cache_info()["plans"] == 1


def test_serve_compaction_repins_chains():
    """``QueryServer.compact()`` re-warms and re-pins the hot plans on the
    torch set: post-compaction waves compile no chain, and their rows
    equal the reference's after its own compaction."""
    base = _motivating()
    ref, ms = _pair(base)
    kt = _triple(base, "KNOWS")
    gopt = GOpt(ms, device="cpu")
    srv = gopt.serve(max_wave=4, overlap=False)
    for _ in range(3):
        srv.submit(Q2HOP)
        srv.drain()
    off = base.v_offset["PERSON"]
    for m in (ref, ms):
        for i in range(4):
            gid = m.insert_vertex("PERSON", {"id": 7600 + i})
            m.insert_edge(kt, off + i, gid)
    ev = srv.compact()
    ref.compact()
    assert ev["repinned_plans"] >= 1
    n_waves = len(srv.stats.wave_chain_compiles)
    r = srv.submit(Q2HOP)
    srv.drain()
    srv.close()
    _table_eq(r.table, RefGOpt(ref, backend="numpy").run(Q2HOP)[0])
    post = srv.stats.wave_chain_compiles[n_waves:]
    assert post and all(c == 0 for c in post), post



def test_explain_delta_section():
    _, _, ms = _mixed(0)
    rep = GOpt(ms, device="cpu").explain(QK)
    assert rep.delta is not None
    txt = rep.render()
    assert "-- delta --" in txt
    assert "overlay_edges" in txt and "snapshot_spread" in txt


def test_mutation_errors_as_the_reference():
    base = _motivating()
    kt = _triple(base, "KNOWS")
    off = base.v_offset["PERSON"]
    csr = base.out_csr[next(t for t in base.out_csr if t.label == "KNOWS")]
    row = int(np.argmax(np.diff(csr.indptr)))
    src, dst = off + row, int(csr.indices[csr.indptr[row]])
    results = []
    for ms in _pair(base):
        with pytest.raises(KeyError):
            ms.insert_vertex("NOPE")
        with pytest.raises(ValueError):
            ms.insert_edge(kt, off, base.n_vertices + 99)
        gid = ms.insert_vertex("PERSON", {"id": 1})
        ms.delete_vertex(gid)
        with pytest.raises(ValueError):
            ms.insert_edge(kt, off, gid)
        results.append([ms.insert_edge(kt, src, dst),
                        ms.delete_edge(kt, src, dst),
                        ms.insert_edge(kt, src, dst),
                        ms.delete_edge(kt, off, off)])
    assert results[0] == results[1] == [False, True, True, False]
    with pytest.raises(TypeError, match="frozen"):
        GOpt(import_store(export_store(base)), device="cpu").insert_vertex(
            "PERSON")


def test_replan_on_binding_skew():
    base = generate_motivating(n_person=200, n_product=60, n_place=12)
    store = import_store(export_store(base))
    gopt = GOpt(store, device="cpu")
    q = ("MATCH (a:PERSON)-[:knows]->(b:PERSON) WHERE a.id IN $S "
         "RETURN a.id AS aid, b.id AS bid ORDER BY aid, bid")
    pq = gopt.prepare(q, params={"S": [1]})
    pq.execute({"S": [1]})
    assert gopt.plan_cache_info()["replans"] == 0
    big = list(range(200))
    tbl, _ = pq.execute({"S": big})
    assert gopt.plan_cache_info()["replans"] == 1
    _table_eq(tbl, RefGOpt(base).run(q, {"S": big})[0])
    pq2 = gopt.prepare(q, params={"S": big})
    pq2.execute({"S": big})
    assert gopt.plan_cache_info()["replans"] == 1


def test_numpy_spec_registers_lazily():
    from repro_torch.core.physical_spec import available_backends, get_spec
    assert {"torch", "numpy"} <= set(available_backends())
    spec = get_spec("numpy")
    assert spec.name == "numpy"
    assert type(spec.operators(_motivating())).__module__ == \
        "repro_torch.graphdb.numpy_backend"
    assert not torch.is_tensor(
        GOpt(import_store(export_store(_motivating())), backend="numpy")
        .run(QK)[0].cols["aid"])
