"""The port's graph ``QueryServer`` (``repro_torch.graphdb.serve``) on the
CPU, the twin of ``tests/test_serve.py`` (the LM engine's twin is
``test_torch_serve.py``).

One LDBC store from the reference's generator, carried across with
``import_store(export_store(...))``, serves on the port's ``torch[cpu]``
spec and its ``numpy`` spec.  Tolerance: exact — every request's rows
equal the reference numpy backend's on the same store, and with
``overlap=False`` on both sides the same request stream gives the same
statuses, rows and ``ServeStats`` wave counters as the reference's
server.  Covered: pow2 wave sizes, duplicate suppression, backpressure,
deadline drops, validation at admission, per-wave ledgers, pinning of hot
chains under LRU pressure, ``explain``'s serve section, the batch
fallbacks, every request terminal under a submit storm (on the overlap
worker thread), ``close`` and the compaction warm loop."""
import threading
import time
import types

import numpy as np
import pytest

from benchmarks import queries as Q
from repro.core.gopt import GOpt as RefGOpt
from repro.graphdb.ldbc import generate_ldbc
from repro.graphdb.serve import ServeOverload as RefServeOverload
from repro_torch.core.errors import ParamError
from repro_torch.core.gopt import GOpt
from repro_torch.graphdb import torch_backend
from repro_torch.graphdb.delta import MutableGraphStore
from repro_torch.graphdb.engine import Engine
from repro_torch.graphdb.serve import (QueryServer, ServeOverload,
                                       ServeStats, _pow2_floor)
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import torch_spec

SIMPLE = ("MATCH (p:PERSON)-[:KNOWS]->(q:PERSON) "
          "WHERE p.id = $pid RETURN q.id AS friend")
CHAIN = ("MATCH (p:PERSON)-[:KNOWS]->(q:PERSON)-[:LIKES]->(m:POST) "
         "WHERE p.id = $pid RETURN q.id AS friend, m.id AS post")
THREE_HOP = ("MATCH (a:PERSON)-[:KNOWS*3]-(z:PERSON) "
             "WHERE a.id = $pid RETURN count(z) AS c")
STRLIT = ("MATCH (p:PERSON)-[:KNOWS]->(q:PERSON) "
          "WHERE p.id = $pid RETURN q.id AS friend, 'hot' AS tag")
# the port's specs: "cpu" is torch[cpu], "numpy" the host spec
BACKENDS = ["cpu", "numpy"]


@pytest.fixture(scope="module")
def ref_store():
    return generate_ldbc(sf=0.05, seed=7)


@pytest.fixture(scope="module")
def ref_gopt(ref_store):
    return RefGOpt(ref_store)


@pytest.fixture(scope="module")
def port_gopt(ref_store):
    return GOpt(import_store(export_store(ref_store)), device="cpu")


def _spec(backend):
    return torch_spec("cpu") if backend == "cpu" else backend


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        x, y = np.asarray(a.cols[k]), np.asarray(b.cols[k])
        assert x.dtype == y.dtype, f"{msg}/{k}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}/{k}")


def _ref_rows(ref_gopt, query, pid):
    return ref_gopt.prepare(query, backend="numpy").execute({"pid": pid})[0]


# ------------------------------------------------------------ wave formation

@pytest.mark.parametrize("backend", BACKENDS)
def test_wave_sizes_follow_pow2_buckets(port_gopt, ref_gopt, backend):
    """With a remainder queued, wave sizes round down to a power of two
    (6 -> 4); the draining wave takes what is left — as the reference."""
    srv = port_gopt.serve(backend=_spec(backend), max_wave=6, overlap=False)
    for pid in range(13):
        srv.submit(SIMPLE, {"pid": pid})
    done = srv.drain()
    srv.close()
    assert len(done) == 13 and all(r.status == "done" for r in done)
    assert srv.stats.wave_sizes == [4, 4, 5]
    assert srv.stats.occupancy == [1.0, 1.0, 5 / 8]
    assert srv.stats.completed == 13
    assert srv.stats.rung_waves == [3, 0, 0]
    for r in done:
        _table_eq(r.table, _ref_rows(ref_gopt, SIMPLE, r.params["pid"]))


def test_wave_dedupes_identical_bindings(port_gopt, ref_gopt):
    srv = port_gopt.serve(max_wave=8, overlap=False)
    reqs = [srv.submit(SIMPLE, {"pid": p}) for p in (1, 2, 1, 2, 1, 2, 1, 1)]
    srv.drain()
    srv.close()
    assert srv.stats.deduped == 6
    for r in reqs:
        assert r.status == "done"
        _table_eq(r.table, _ref_rows(ref_gopt, SIMPLE, r.params["pid"]))
    assert reqs[0].table is reqs[2].table       # fanned out, not re-run


def test_pow2_floor():
    assert [_pow2_floor(n) for n in (1, 2, 3, 6, 8, 13)] == [1, 2, 2, 4, 8, 8]


def test_waves_are_not_padded_on_the_torch_set(port_gopt):
    """The torch set compiles nothing (``compiled`` is False), so its waves
    run unpadded, as the reference pads only on compiling backends."""
    assert port_gopt.spec.operators(port_gopt.store).compiled is False
    seen = []
    srv = port_gopt.serve(max_wave=8, overlap=False)
    pq = port_gopt.prepare(SIMPLE)
    real = type(pq).execute_many

    def spy(self, bindings, **kw):
        seen.append(len(bindings))
        return real(self, bindings, **kw)

    type(pq).execute_many = spy
    try:
        for pid in range(3):
            srv.submit(SIMPLE, {"pid": pid})
        srv.drain()
    finally:
        type(pq).execute_many = real
        srv.close()
    assert seen == [3]


# ------------------------------------------------------------------- parity

@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_parity_mixed_plans(port_gopt, ref_gopt, backend):
    """Interleaved traffic over two plans, coalesced per plan on the
    overlap worker, is row-identical to the reference per request."""
    srv = port_gopt.serve(backend=_spec(backend), max_wave=4, overlap=True)
    tagged = []
    for p in range(6):
        tagged.append((SIMPLE, srv.submit(SIMPLE, {"pid": p})))
        tagged.append((CHAIN, srv.submit(CHAIN, {"pid": p})))
    done = srv.drain()
    srv.close()
    assert len(done) == 12
    for q, r in tagged:
        assert r.status == "done"
        _table_eq(r.table, _ref_rows(ref_gopt, q, r.params["pid"]),
                  f"{q[:30]}/{r.params}")
    assert len(srv.stats.per_plan) == 2
    assert sum(p["waves"] for p in srv.stats.per_plan.values()) \
        == srv.stats.waves


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_stream_same_outcome_as_the_reference(ref_store, backend):
    """``overlap=False`` on both sides: one stream (two plans, duplicate
    bindings, expired deadlines, more than the queue holds) gives the
    same statuses, rows and wave counters as the reference server."""
    rng = np.random.default_rng(4)
    stream = [((SIMPLE, CHAIN, STRLIT)[int(rng.integers(0, 3))],
               int(rng.integers(0, 9)), bool(rng.random() < 0.15))
              for _ in range(40)]
    out = []
    for side in ("ref", "port"):
        if side == "ref":
            g, kw = RefGOpt(ref_store, build_glogue=False), {
                "backend": "numpy"}
        else:
            g = GOpt(import_store(export_store(ref_store)),
                     build_glogue=False, device="cpu")
            kw = {"backend": _spec(backend)}
        srv = g.serve(max_wave=4, max_pending=24, overlap=False, **kw)
        reqs, rejected = [], 0
        past = time.perf_counter() - 1.0
        for i, (q, pid, expired) in enumerate(stream):
            if i == 30:
                srv.drain()
            try:
                reqs.append(srv.submit(q, {"pid": pid},
                                       deadline_s=past if expired else None))
            except (ServeOverload, RefServeOverload):
                rejected += 1
        srv.drain()
        srv.close()
        s = srv.stats
        out.append((reqs, rejected, {
            k: getattr(s, k) for k in (
                "submitted", "completed", "rejected", "dropped", "deduped",
                "failed", "retries", "bisections", "waves", "wave_sizes",
                "occupancy", "breaker_trips")}))
    (rr, rrej, rs), (pr, prej, ps) = out
    assert rrej == prej > 0 and rs == ps
    assert len(rr) == len(pr)
    for a, b in zip(rr, pr):
        assert a.status == b.status and a.params == b.params
        if a.status == "done":
            _table_eq(b.table, a.table, f"{a.params}")


# --------------------------------------------------------- admission control

def test_backpressure_bounded_queue(port_gopt):
    srv = port_gopt.serve(max_pending=3, overlap=False)
    for pid in range(3):
        srv.submit(SIMPLE, {"pid": pid})
    with pytest.raises(ServeOverload):
        srv.submit(SIMPLE, {"pid": 99})
    assert srv.stats.rejected == 1
    done = srv.drain()
    srv.close()
    assert len(done) == 3 and srv.stats.completed == 3


def test_deadline_drop_at_wave_formation(port_gopt):
    srv = port_gopt.serve(overlap=False)
    live = [srv.submit(SIMPLE, {"pid": p}) for p in (1, 2)]
    past = time.perf_counter() - 1.0
    dead = [srv.submit(SIMPLE, {"pid": p}, deadline_s=past) for p in (3, 4)]
    srv.drain()
    srv.close()
    assert all(r.status == "done" for r in live)
    assert all(r.status == "dropped" and r.table is None for r in dead)
    assert srv.stats.dropped == 2 and srv.stats.completed == 2


def test_admission_validates_bindings(port_gopt):
    srv = port_gopt.serve()
    with pytest.raises(ParamError):
        srv.submit(SIMPLE, {"nope": 1})
    with pytest.raises(ParamError):
        srv.submit(SIMPLE, {})
    assert srv.pending == 0 and srv.stats.submitted == 0
    srv.close()


def test_updates_need_a_mutable_store(port_gopt):
    srv = port_gopt.serve(overlap=False)
    with pytest.raises(TypeError, match="frozen"):
        srv.submit_update("insert_vertex", "PERSON")
    with pytest.raises(ValueError, match="unknown update kind"):
        srv.submit_update("upsert", 1)
    srv.close()


# ------------------------------------------------------- wave-scoped ledgers

def test_ledgers_scoped_per_wave(port_gopt):
    """Both ledgers reset at each wave's start: warmed waves of equal size
    leave equal, small ledgers behind."""
    srv = port_gopt.serve(max_wave=4, overlap=False)
    ops = port_gopt.spec.operators(port_gopt.store)
    lens = []
    for pid in range(12):
        srv.submit(CHAIN, {"pid": pid})
    while srv.pending:
        srv.step()
        lens.append((ops.kernel_stats.mark(), ops.transfer_stats.mark()))
    srv.close()
    assert len(lens) == 3
    assert 0 < lens[2][0] <= lens[1][0]
    assert 0 < lens[2][1] <= lens[1][1]


# ------------------------------------------------------------ hotness pinning

def test_hot_chain_survives_lru_pressure(port_gopt):
    """Serving pins the hot plan's fused-chain handle on the torch set;
    LRU pressure evicts unpinned entries around it, and the pinned one
    once released."""
    srv = port_gopt.serve(max_wave=8, overlap=False, hot_plans=1)
    for _ in range(2):                  # the first run measures the chain
        for pid in range(8):
            srv.submit(CHAIN, {"pid": pid})
        srv.drain()
    srv.close()
    ops = port_gopt.spec.operators(port_gopt.store)
    pinned = [k for k, v in ops._chains.items()
              if getattr(v, "pinned", False)]
    assert pinned, "serving a single hot plan must pin its chain"
    fakes = []
    try:
        i = 0
        while len(ops._chains) < torch_backend._CHAIN_SHAPES:
            k = ("fake", i)
            ops._chains[k] = types.SimpleNamespace(pinned=False)
            fakes.append(k)
            i += 1
        port_gopt.prepare(THREE_HOP).execute({"pid": 5})
        assert all(k in ops._chains for k in pinned)
        assert any(k not in ops._chains for k in fakes)
        for k in pinned:
            ops._chains[k].pinned = False
        while len(ops._chains) < torch_backend._CHAIN_SHAPES:
            k = ("fake", i)
            ops._chains[k] = types.SimpleNamespace(pinned=False)
            fakes.append(k)
            i += 1
        port_gopt.prepare(Q.QIC["ic12"]).execute({"pid": 5})
        assert any(k not in ops._chains for k in pinned)
    finally:
        for k in fakes:
            ops._chains.pop(k, None)


def test_warm_server_compiles_stay_flat(port_gopt):
    """Once each chain is measured, a warmed server's waves compile no
    chain program and dispatch the chain fused."""
    srv = port_gopt.serve(max_wave=8, overlap=False)
    for pid in range(32):
        srv.submit(CHAIN, {"pid": pid})
    done = srv.drain()
    srv.close()
    assert len(done) == 32 and sum(srv.stats.wave_sizes) == 32
    assert srv.stats.wave_compiles[-1] == 0, srv.stats.wave_compiles
    assert srv.stats.wave_chain_compiles[-1] == 0


# ----------------------------------------------------------- EXPLAIN surface

def test_explain_carries_serve_section(port_gopt):
    srv = port_gopt.serve(max_wave=4, overlap=False)
    for pid in range(8):
        srv.submit(SIMPLE, {"pid": pid})
    srv.drain()
    report = srv.explain(SIMPLE)
    srv.close()
    assert report.serve and report.serve["requests"] == 8
    txt = report.render()
    assert "-- serve --" in txt and "mean_wave_size" in txt


def test_serve_stats_render_smoke():
    s = ServeStats()
    txt = s.render()
    assert "0/0 completed" in txt and "waves by rung=[0, 0, 0]" in txt
    assert s.summary()["rung_waves"] == [0, 0, 0]


# ------------------------------------------- run_batch fallback bookkeeping

def test_stacked_tail_error_falls_back_to_loop(port_gopt, monkeypatch):
    bindings = [{"pid": p} for p in (1, 3, 5)]
    pq = port_gopt.prepare(Q.QIC["ic1"])
    loop = pq.execute_many(bindings, batch=False)

    def boom(self, *a, **k):
        raise RuntimeError("segment stack exploded")

    monkeypatch.setattr(Engine, "_run_tails_stacked", boom)
    batched = pq.execute_many(bindings, batch=True)
    for (lt, _), (bt, bst) in zip(loop, batched):
        _table_eq(lt, bt)
        assert bst.fallbacks.get("stacked_tail_error") == 1, bst.fallbacks


@pytest.mark.parametrize("backend", BACKENDS)
def test_unstackable_tail_records_fallback(port_gopt, backend):
    bindings = [{"pid": p} for p in (1, 2, 3)]
    pq = port_gopt.prepare(STRLIT, backend=_spec(backend))
    loop = pq.execute_many(bindings, batch=False)
    batched = pq.execute_many(bindings, batch=True)
    for (lt, _), (bt, bst) in zip(loop, batched):
        _table_eq(lt, bt)
        assert bst.fallbacks.get("tail_unstackable") == 1, bst.fallbacks
    assert all(not lst.fallbacks for _, lst in loop)


def test_mixed_backend_servers_isolated_ledgers(port_gopt, ref_gopt):
    """A numpy server and a torch[cpu] server over one store: interleaved
    traffic stays row-identical, and numpy waves add no event to the
    torch set's ledger."""
    srv_np = port_gopt.serve(backend="numpy", max_wave=4, overlap=False)
    srv_t = port_gopt.serve(max_wave=4, overlap=False)
    tops = port_gopt.spec.operators(port_gopt.store)
    np_results, t_results = [], []
    for p in range(8):
        np_results.append(srv_np.submit(SIMPLE, {"pid": p}))
        t_results.append(srv_t.submit(SIMPLE, {"pid": p}))
    while srv_t.pending:
        srv_t.step()
    m = tops.kernel_stats.mark()
    while srv_np.pending:
        srv_np.step()
    assert tops.kernel_stats.mark() == m
    srv_np.close()
    srv_t.close()
    for r in np_results + t_results:
        assert r.status == "done"
        _table_eq(r.table, _ref_rows(ref_gopt, SIMPLE, r.params["pid"]))
    assert sum(p["waves"] for p in srv_np.stats.per_plan.values()) \
        == srv_np.stats.waves > 0
    assert sum(p["waves"] for p in srv_t.stats.per_plan.values()) \
        == srv_t.stats.waves > 0


# --------------------------------------------------------- fault tolerance

def test_submit_storm_every_request_terminal(port_gopt, ref_gopt):
    """Four submitter threads race the serving loop, whose waves run on the
    overlap worker thread over torch[cpu]: every admitted request ends
    terminal and the conservation equation holds."""
    srv = port_gopt.serve(max_wave=8, max_pending=64, overlap=True)
    accepted, rejected = [], []
    lock = threading.Lock()

    def storm(seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            q = (SIMPLE, STRLIT)[int(rng.integers(0, 2))]
            try:
                r = srv.submit(q, {"pid": int(rng.integers(0, 12))})
                with lock:
                    accepted.append(r)
            except ServeOverload:
                with lock:
                    rejected.append(1)
            if rng.random() < 0.1:
                time.sleep(0.001)

    threads = [threading.Thread(target=storm, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) or srv.pending:
        srv.step()
    for t in threads:
        t.join()
    srv.drain()
    srv.close()
    terminal = {"done", "failed", "dropped", "cancelled"}
    assert len(accepted) + len(rejected) == 160
    assert all(r.status in terminal for r in accepted)
    s = srv.stats.summary()
    assert s["submitted"] == len(accepted)
    assert s["rejected"] == len(rejected)
    assert s["submitted"] == (s["completed"] + s["failed"] + s["dropped"]
                              + s["cancelled"])
    assert s["failed"] == s["dropped"] == s["cancelled"] == 0
    assert s["rung_waves"][1:] == [0, 0]
    for r in accepted:
        if r.prepared.source == SIMPLE:
            _table_eq(r.table, _ref_rows(ref_gopt, SIMPLE, r.params["pid"]))


def test_close_cancels_queued_requests(port_gopt):
    srv = port_gopt.serve(overlap=False)
    done = srv.submit(SIMPLE, {"pid": 1})
    srv.drain()
    queued = [srv.submit(SIMPLE, {"pid": p}) for p in (2, 3)]
    srv.close()
    assert done.status == "done"
    assert all(r.status == "cancelled" for r in queued)
    assert all(r.finish_s > 0 for r in queued)
    assert srv.stats.cancelled == 2 and srv.pending == 0
    s = srv.stats.summary()
    assert s["submitted"] == (s["completed"] + s["failed"] + s["dropped"]
                              + s["cancelled"])


def test_compact_counts_unwarmable_plans(ref_store):
    gopt = GOpt(MutableGraphStore(import_store(export_store(ref_store))),
                device="cpu")
    gopt.store.insert_vertex("PERSON", {"id": 800_000})
    srv = gopt.serve(overlap=False, hot_plans=2)
    assert isinstance(srv, QueryServer)
    for p in range(4):
        srv.submit(SIMPLE, {"pid": p})
    srv.drain()
    key = next(iter(srv._plans))
    srv._samples[key] = None
    ev = srv.compact()
    assert ev["warm_skips"] == 1 and ev["repinned_plans"] == 0
    for p in range(4):
        srv.submit(SIMPLE, {"pid": p})
    srv.drain()
    srv._samples[key] = {"pid": 0}
    srv.exec_kw = dict(srv.exec_kw, not_an_exec_kwarg=1)
    with pytest.raises(TypeError):
        srv.compact()
    srv.close()
