"""Fault injection and containment on the port (``repro_torch.graphdb.
faults`` and the ``QueryServer`` ladder), the twin of
``tests/test_faults.py``, on the CPU.

The same ``FaultPlan`` over the same stream fires the same schedule in the
port and in the reference; the wrapper conforms on ``torch[cpu]`` (its
int32 staging dtype forwarded) and on the port's ``numpy`` spec;
bisection isolates a poison binding and quarantines it; the breaker walks
the ladder down and back up as the reference's does on the same faults;
latency faults meet deadlines; a crashed overlap worker is re-formed
once; one bad mutation fails alone; and a permanent ``intersect`` fault
on ``torch[cpu]`` sends a plan to rung 2 (the port's ``numpy`` spec) with
rows equal to the fault-free run.  Beyond the reference: a server over a
card set has no host rung unless ``fallback_spec`` asks for one, and a
plain ``RuntimeError`` (a kernel or CUDA error) fails its request without
walking the ladder.  Tolerance: exact."""
import time

import numpy as np
import pytest

from repro.core.gopt import GOpt as RefGOpt
from repro.graphdb import faults as ref_faults
from repro.graphdb.ldbc import generate_ldbc, generate_motivating
from repro_torch.core.errors import (DeadlineExceeded, ExecError,
                                     PermanentExecError, TransientExecError,
                                     classify_error)
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical_spec import FaultStats, validate_operator_set
from repro_torch.graphdb import faults as port_faults
from repro_torch.graphdb.delta import MutableGraphStore
from repro_torch.graphdb.faults import (FAULT_POINTS, FaultPlan, FaultRule,
                                        FaultyOperatorSet, InjectedFault,
                                        faulty_spec)
from repro_torch.graphdb.serve import ServeQuarantined
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import torch_spec

SIMPLE = ("MATCH (p:PERSON)-[:KNOWS]->(q:PERSON) "
          "WHERE p.id = $pid RETURN q.id AS friend")
CHAIN = ("MATCH (p:PERSON)-[:KNOWS]->(q:PERSON)-[:LIKES]->(m:POST) "
         "WHERE p.id = $pid RETURN q.id AS friend, m.id AS post")
TRIANGLE = ("MATCH (p:PERSON)-[:KNOWS]->(a:PERSON), (p)-[:KNOWS]->"
            "(b:PERSON), (a)-[:KNOWS]->(b) WHERE p.id = $pid "
            "RETURN a.id AS x, b.id AS y ORDER BY x, y")


@pytest.fixture(scope="module")
def ref_tiny():
    return generate_motivating(n_person=50, n_product=20, n_place=8)


@pytest.fixture()
def tiny_gopt(ref_tiny):
    return GOpt(import_store(export_store(ref_tiny)), device="cpu")


@pytest.fixture(scope="module")
def ldbc_pair():
    store = generate_ldbc(sf=0.05, seed=7)
    return store, GOpt(import_store(export_store(store)), device="cpu")


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        np.testing.assert_array_equal(np.asarray(a.cols[k]),
                                      np.asarray(b.cols[k]),
                                      err_msg=f"{msg}/{k}")


def _cpu():
    return torch_spec("cpu")


# ------------------------------------------------------------------ FaultPlan

def _trial(mod):
    plan = mod.FaultPlan([mod.FaultRule(op="expand", after=1, count=2),
                          mod.FaultRule(op="scan", p=0.5, count=None),
                          mod.FaultRule(op="full", kind="permanent",
                                        value=13, count=None)], seed=11)
    out = []
    for i in range(12):
        out.append(plan.check("expand") is not None)
        out.append(plan.check("scan") is not None)
        out.append(plan.check("full", (i + 8, 0), wildcard=False) is not None)
    return out, plan.fired


def test_fault_plan_schedule_equals_the_reference():
    """One seeded plan fires the same calls in the port and in the
    reference, and replays after ``reset``."""
    mine = _trial(port_faults)
    assert mine == _trial(port_faults)
    assert mine == _trial(ref_faults)
    plan = FaultPlan([FaultRule(op="scan", p=0.5, count=None)], seed=11)
    first = [plan.check("scan") is not None for _ in range(8)]
    plan.reset()
    assert [plan.check("scan") is not None for _ in range(8)] == first


def test_fault_plan_after_count_window():
    plan = FaultPlan([FaultRule(op="join", after=2, count=2)])
    fired = [plan.check("join") is not None for _ in range(6)]
    assert fired == [False, False, True, True, False, False]
    assert plan.fired == 2


def test_fault_rule_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultRule(kind="catastrophic")
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultRule(op="frobnicate")
    assert "bind" in FAULT_POINTS and "chain" in FAULT_POINTS
    assert FAULT_POINTS == ref_faults.FAULT_POINTS


def test_value_matched_rules_need_explicit_op():
    plan = FaultPlan([FaultRule(op="*", kind="permanent", count=None)])
    assert plan.check("full", (5, 0), wildcard=False) is None
    assert plan.check("expand") is not None


# ------------------------------------------------------- conforming wrapper

@pytest.mark.parametrize("backend", ["cpu", "numpy"])
def test_faulty_wrapper_passes_conformance(ref_tiny, backend):
    inner = _cpu() if backend == "cpu" else "numpy"
    spec = faulty_spec(inner, FaultPlan([]))
    ops = spec.operators(import_store(export_store(ref_tiny)))
    assert isinstance(ops, FaultyOperatorSet)
    assert ops.index_dtype is ops.inner.index_dtype
    assert spec.physical_rules == (_cpu().physical_rules if backend == "cpu"
                                   else ())
    validate_operator_set(ops, conformance=True)


def test_wrapper_ledgers_delegate_except_faults(ref_tiny):
    plan = FaultPlan([FaultRule(op="scan", kind="transient")])
    ops = faulty_spec(_cpu(), plan).operators(
        import_store(export_store(ref_tiny)))
    assert ops.transfer_stats is ops.inner.transfer_stats
    assert ops.kernel_stats is ops.inner.kernel_stats
    assert isinstance(ops.fault_stats, FaultStats)
    with pytest.raises(InjectedFault) as ei:
        ops.scan(0, 4)
    assert ei.value.transient
    assert ops.fault_stats.summary() == {"transient:scan": 1}
    ops.reset_ledgers()
    assert ops.fault_stats.summary() == {}


def test_injected_fault_carries_context(ref_tiny):
    plan = FaultPlan([FaultRule(op="scan", kind="permanent")])
    ops = faulty_spec("numpy", plan).operators(
        import_store(export_store(ref_tiny)))
    with pytest.raises(InjectedFault) as ei:
        ops.scan(0, 4)
    assert ei.value.kind == "permanent" and ei.value.operator == "scan"
    assert isinstance(ei.value, ExecError)


# ------------------------------------------------------------ error taxonomy

def test_exec_error_taxonomy():
    e = ExecError("boom", operator="expand", phase="pattern", plan="k")
    assert e.kind == "permanent" and not e.transient
    assert "op=expand" in str(e) and "phase=pattern" in str(e)
    assert TransientExecError("x").transient
    assert not PermanentExecError("x").transient
    assert DeadlineExceeded("x").kind == "deadline"
    assert classify_error(TimeoutError()) == "transient"
    assert classify_error(RuntimeError("x")) == "permanent"


# --------------------------------------------------------- engine deadlines

def test_deadline_aborts_mid_execution(tiny_gopt):
    with pytest.raises(DeadlineExceeded) as ei:
        tiny_gopt.run(SIMPLE, params={"pid": 1},
                      deadline_s=time.perf_counter() - 1.0)
    assert ei.value.kind == "deadline" and ei.value.operator


def test_deadline_survives_engine_fallbacks(tiny_gopt):
    pq = tiny_gopt.prepare(SIMPLE)
    with pytest.raises(DeadlineExceeded):
        pq.execute_many([{"pid": 1}, {"pid": 2}], batch=True,
                        deadline_s=time.perf_counter() - 1.0)


# ------------------------------------------------------- serving containment

@pytest.mark.parametrize("backend", ["cpu", "numpy"])
def test_transient_faults_retry_to_success(tiny_gopt, ref_tiny, backend):
    inner = _cpu() if backend == "cpu" else "numpy"
    plan = FaultPlan([FaultRule(op="expand", kind="transient", count=2)])
    srv = tiny_gopt.serve(backend=faulty_spec(inner, plan), overlap=False)
    r = srv.submit(SIMPLE, {"pid": 3})
    srv.drain()
    srv.close()
    assert r.status == "done" and r.error is None
    assert srv.stats.retries == 2 and srv.stats.failed == 0
    assert plan.fired == 2
    _table_eq(r.table, RefGOpt(ref_tiny).run(SIMPLE, {"pid": 3})[0])


def _poison_run(gopt, mod, inner, fallback):
    rule = mod.FaultRule(op="bind", kind="permanent", value=13, count=None)
    srv = gopt.serve(
        backend=mod.faulty_spec(inner, mod.FaultPlan([rule])),
        overlap=False, quarantine_after=2, breaker_threshold=99,
        fallback_spec=mod.faulty_spec(fallback, mod.FaultPlan([rule])))
    reqs = [srv.submit(SIMPLE, {"pid": p}) for p in (10, 13, 20, 25)]
    srv.drain()
    r2 = srv.submit(SIMPLE, {"pid": 13})
    srv.drain()
    quarantined = None
    try:
        srv.submit(SIMPLE, {"pid": 13})
    except Exception as exc:          # the side's own ServeQuarantined
        quarantined = exc
    r3 = srv.submit(SIMPLE, {"pid": 10})
    srv.drain()
    srv.close()
    s = srv.stats
    return (reqs + [r2, r3], quarantined,
            (s.bisections, s.failed, s.quarantined, s.retries, s.waves,
             s.breaker_trips))


def test_poison_binding_is_bisected_and_quarantined(tiny_gopt, ref_tiny):
    """A binding that fails at every rung fails alone (the wave is
    bisected), is quarantined on its second failure, and the port's
    statuses, rows and counters equal the reference's on the same faults
    (torch[cpu] over the numpy rung, against the reference's numpy over
    numpy)."""
    got, q, counters = _poison_run(tiny_gopt, port_faults, _cpu(), "numpy")
    want, rq, rcounters = _poison_run(RefGOpt(ref_tiny), ref_faults,
                                      "numpy", "numpy")
    assert [r.status for r in got] == ["done", "failed", "done", "done",
                                      "failed", "done"]
    assert [r.status for r in got] == [r.status for r in want]
    assert isinstance(q, ServeQuarantined)
    assert type(rq).__name__ == "ServeQuarantined"
    assert counters == rcounters
    assert counters[:3] == (2, 2, 1)
    assert got[1].error.kind == "permanent"
    for a, b in zip(got, want):
        if a.status == "done":
            _table_eq(a.table, b.table)


def test_breaker_ladder_trips_probes_and_recovers(ldbc_pair):
    """Three permanent faults at the fused-chain boundary: the breaker
    trips to the per-hop loop, probes back after two clean waves, and
    recovers to rung 0, with every request done and its rows equal to
    the reference numpy backend's."""
    ref_store, gopt = ldbc_pair
    plan = FaultPlan([FaultRule(op="chain", kind="permanent", count=3)])
    srv = gopt.serve(backend=faulty_spec(_cpu(), plan), overlap=False,
                     probe_after=2)
    rg = RefGOpt(ref_store)
    for i in range(14):
        r = srv.submit(CHAIN, {"pid": i})
        srv.drain()
        assert r.status == "done", (i, r.status, r.error)
        _table_eq(r.table, rg.run(CHAIN, {"pid": i})[0], f"pid {i}")
    (key, b), = srv._breakers.items()
    assert b["trips"] == 1 and b["probes"] == 3 and b["recoveries"] == 1
    assert b["level"] == 0
    assert srv.stats.breaker_trips == 1 == srv.stats.breaker_recoveries
    assert srv.stats.rung_waves[2] == 0 and srv.stats.rung_waves[1] > 0
    assert plan.fired == 3
    rep = srv.explain(CHAIN, params={"pid": 0})
    srv.close()
    assert rep.serve["breaker"]["trips"] == 1


def test_permanent_intersect_fault_walks_to_the_numpy_rung(ldbc_pair):
    """A permanent fault on every ``intersect`` of ``torch[cpu]`` fails the
    plan at rung 0 and at rung 1 (the per-hop loop probes through
    ``intersect`` as well); rung 2, the port's ``numpy`` spec, answers
    with the fault-free rows, the breaker stays there, and ``ServeStats``
    counts those waves as host waves."""
    ref_store, gopt = ldbc_pair
    plan = FaultPlan([FaultRule(op="intersect", kind="permanent",
                                count=None)])
    srv = gopt.serve(backend=faulty_spec(_cpu(), plan), overlap=False,
                     fallback_spec="numpy")
    reqs = []
    for pid in (3, 5, 8):
        reqs.append(srv.submit(TRIANGLE, {"pid": pid}))
        srv.drain()
    srv.close()
    rg = RefGOpt(ref_store)
    for r in reqs:
        assert r.status == "done", r.error
        clean, _ = gopt.run(TRIANGLE, {"pid": r.params["pid"]})
        _table_eq(r.table, clean)
        _table_eq(r.table, rg.run(TRIANGLE, {"pid": r.params["pid"]})[0])
    assert sum(r.table.nrows for r in reqs) > 0
    (key, b), = srv._breakers.items()
    assert b["level"] == 2 and b["trips"] == 1
    assert srv.stats.rung_waves == [0, 0, 3]
    assert srv.stats.failed == 0 and plan.fired >= 2


def _device_like(gopt, plan, monkeypatch):
    """A fault-wrapped ``torch[cpu]`` spec whose set reports itself as a
    card set, so the server resolves its default host rung as it does on
    cuda."""
    spec = faulty_spec(_cpu(), plan)
    monkeypatch.setattr(spec.operators(gopt.store), "on_host", False)
    return spec


@pytest.mark.parametrize("fallback", ["auto", "numpy"])
def test_device_set_has_no_host_rung_unless_asked(ldbc_pair, monkeypatch,
                                                  fallback):
    """Over a card set the default server has no rung 2: a permanent
    ``intersect`` fault fails the request after the per-hop rung and no
    wave runs on the host.  Passing ``fallback_spec="numpy"`` opts in,
    and the request is answered there with the fault-free rows."""
    _, gopt = ldbc_pair
    plan = FaultPlan([FaultRule(op="intersect", kind="permanent",
                                count=None)])
    # chain_dispatch=False: rung 0 probes through ``intersect`` even when
    # an earlier test has warmed this chain's fused program
    srv = gopt.serve(backend=_device_like(gopt, plan, monkeypatch),
                     overlap=False, fallback_spec=fallback,
                     chain_dispatch=False)
    r = srv.submit(TRIANGLE, {"pid": 3})
    srv.drain()
    srv.close()
    if fallback == "auto":
        assert srv.fallback_spec is None
        assert r.status == "failed" and r.error.kind == "permanent"
        assert srv.stats.rung_waves == [1, 0, 0]
        assert srv.stats.failed == 1 and plan.fired == 2
    else:
        assert r.status == "done", r.error
        _table_eq(r.table, gopt.run(TRIANGLE, {"pid": 3})[0])
        assert srv.stats.rung_waves == [0, 0, 1]


def test_plain_runtime_error_fails_without_walking_the_ladder(
        ldbc_pair, monkeypatch):
    """A plain ``RuntimeError`` from an operator (what a kernel build or
    launch failure or a CUDA error raises) fails its request at the rung
    it hit, even on a host set with a host rung: it never reaches rung 1
    or rung 2."""
    _, gopt = ldbc_pair
    spec = faulty_spec(_cpu(), FaultPlan([]))
    ops = spec.operators(gopt.store)
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(ops, "intersect", broken)
    srv = gopt.serve(backend=spec, overlap=False, chain_dispatch=False)
    assert srv.fallback_spec == "numpy"
    r = srv.submit(TRIANGLE, {"pid": 3})
    srv.drain()
    srv.close()
    assert r.status == "failed" and calls["n"] == 1
    assert isinstance(r.error, ExecError)
    assert isinstance(r.error.cause, RuntimeError)
    assert "illegal memory access" in str(r.error)
    assert srv.stats.rung_waves == [1, 0, 0] and srv.stats.failed == 1
    (key, b), = srv._breakers.items()
    assert b["level"] == 0 and b["trips"] == 0


def test_latency_fault_plus_deadline_aborts(tiny_gopt):
    plan = FaultPlan([FaultRule(op="bind", kind="latency", latency_s=0.06,
                                value=5, count=1)])
    srv = tiny_gopt.serve(backend=faulty_spec(_cpu(), plan), overlap=False)
    r = srv.submit(SIMPLE, {"pid": 5},
                   deadline_s=time.perf_counter() + 0.02)
    srv.drain()
    srv.close()
    assert r.status == "dropped"
    assert srv.stats.deadline_aborts == 1 and srv.stats.failed == 0


def test_worker_crash_respawns_and_reforms_wave_once(tiny_gopt):
    srv = tiny_gopt.serve(overlap=True)
    orig, crashes = srv._run_wave, {"n": 0}

    def crashing(key, reqs):
        if crashes["n"] == 0:
            crashes["n"] += 1
            raise MemoryError("simulated worker crash")
        return orig(key, reqs)

    srv._run_wave = crashing
    reqs = [srv.submit(SIMPLE, {"pid": p}) for p in (1, 2, 3)]
    srv.drain()
    srv.close()
    assert all(r.status == "done" for r in reqs)
    assert all(r.respawned for r in reqs)
    assert srv.stats.worker_respawns == 1 and srv.stats.failed == 0


def test_second_crash_fails_the_wave(tiny_gopt):
    srv = tiny_gopt.serve(overlap=True)

    def always_crashing(key, reqs):
        raise MemoryError("boom")

    srv._run_wave = always_crashing
    r = srv.submit(SIMPLE, {"pid": 1})
    srv.drain()
    srv.close()
    assert r.status == "failed" and r.error is not None
    assert srv.stats.worker_respawns == 1
    assert srv._offenders == {}


def test_uncontained_mode_raises_and_strands_nothing(tiny_gopt):
    plan = FaultPlan([FaultRule(op="expand", kind="transient", count=1)])
    srv = tiny_gopt.serve(backend=faulty_spec(_cpu(), plan),
                          overlap=False, containment=False)
    r = srv.submit(SIMPLE, {"pid": 1})
    with pytest.raises(InjectedFault):
        srv.drain()
    srv.close()
    assert r.status == "failed"


def test_write_containment_isolates_bad_mutation():
    base = generate_motivating(n_person=30, n_product=10, n_place=4)
    g = GOpt(MutableGraphStore(import_store(export_store(base))),
             device="cpu")
    srv = g.serve(overlap=True)
    ok = srv.submit_update("insert_vertex", "PERSON", {"id": 777_000})
    bad = srv.submit_update("insert_edge", "NOT-AN-EDGE-TYPE", 0, 1)
    ok2 = srv.submit_update("insert_vertex", "PERSON", {"id": 777_001})
    srv.drain()
    srv.close()
    assert ok.status == "done" and ok2.status == "done"
    assert bad.status == "failed" and bad.error is not None
    assert srv.stats.writes == 2 and srv.stats.failed == 1
    assert ok2.result == ok.result + 1 == g.store.id_space - 1
