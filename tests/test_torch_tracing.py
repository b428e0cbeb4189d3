"""The engine's spans and host-sync count (``ExecStats.spans``,
``ExecStats.host_syncs``), and the bounded ledgers of the operator set, on
the CPU: the span tree of one ``GOpt.run`` is well formed and stamped on
the profiler's clock, PROFILE reads its times off the spans and prints what
it printed before, the sync count is pinned for three plan shapes, and the
ledgers stay bounded over many runs while a held mark still reads its
events and a mark left unreleased does not keep the history."""
import re

import pytest

from repro_torch.core.gopt import GOpt
from repro_torch.core.physical_spec import TransferStats
from repro_torch.graphdb.engine import ExecStats, span_clock
from repro_torch.graphdb.ldbc import generate_motivating

POINT = ("MATCH (p:Person) WHERE p.id = $x RETURN p.name", {"x": 7})
CHAIN = ("MATCH (p:Person)-[:KNOWS]->(f:Person)-[:KNOWS]->(h:Person) "
         "WHERE p.id = $x RETURN h.id", {"x": 3})
JOIN = ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)"
        "-[:KNOWS]->(d:Person)-[:KNOWS]->(e:Person) "
        "WHERE a.id = 1 AND e.id = 2 RETURN count(c)", None)
TAIL = ("MATCH (p:Person)-[:KNOWS]->(f:Person)-[:KNOWS]->(h:Person) "
        "WHERE p.id = $x RETURN h.id, count(f) AS n ORDER BY n DESC, h.id "
        "LIMIT 5", {"x": 3})
EXPAND = ("MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.id = $x "
          "RETURN b.id", {"x": 4})
QUERIES = {"point": POINT, "chain": CHAIN, "join": JOIN, "tail": TAIL,
           "expand": EXPAND}


@pytest.fixture(scope="module")
def gopt():
    g = GOpt(generate_motivating(n_person=50, n_product=20, n_place=8),
             device="cpu")
    for text, params in QUERIES.values():   # device caches, chain handles
        g.run(text, params)
    return g


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[3] == i]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_span_tree_is_well_formed(gopt, name):
    text, params = QUERIES[name]
    tbl, st = gopt.run(text, params)
    spans = st.spans
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert roots == [0] and spans[0][0] == "gopt.run"
    for name_, a, b, parent in spans:
        assert 0 < a <= b, name_
        if parent >= 0:
            _, pa, pb, _ = spans[parent]
            assert pa <= a and b <= pb, (name_, spans[parent][0])
    assert [spans[i][0] for i in _children(spans, 0)] == \
        ["plan", "engine.setup", "pattern", "tail", "deliver"]
    # one span per logged operator, each a child of its phase
    assert [spans[i][0] for i in st.op_spans] == [n for n, _ in st.op_rows]
    for i in st.op_spans:
        assert spans[spans[i][3]][0] in ("pattern", "tail")
    assert st.op_times == [
        (spans[i][0], (spans[i][2] - spans[i][1]) * 1e-9)
        for i in st.op_spans]
    # each run has a record of its own, after the last one's
    _, again = gopt.run(text, params)
    assert again.spans is not spans and again.spans[0][1] >= spans[0][2]


def test_steps_inside_an_operator_are_its_children(gopt):
    _, st = gopt.run(*TAIL)
    names = {s[0]: i for i, s in enumerate(st.spans)}
    scan = names["SCAN(p)"]
    assert [st.spans[i][0] for i in _children(st.spans, scan)] == ["FILTER"]
    tail = names["tail"]
    # ORDER ... LIMIT is a span of the tail, not an operator of op_rows
    assert [st.spans[i][0] for i in _children(st.spans, tail)] == \
        ["GROUP", "ORDER"]
    assert "ORDER" not in [n for n, _ in st.op_rows]
    # the per-hop loop's probe is a step of its chain
    text = ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person), "
            "(a)-[:KNOWS]->(c) RETURN count(a)")
    _, st = gopt.prepare(text).execute(chain_dispatch=False)
    (probe,) = [s for s in st.spans if s[0].startswith("INTERSECT(")]
    assert st.spans[probe[3]][0].startswith("EXPANDCHAIN(")


def test_spans_share_the_profilers_clock(gopt):
    """The aten events an EXPAND runs start and end inside its span."""
    from torch.profiler import ProfilerActivity, profile
    t0 = span_clock()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = gopt.run(*EXPAND)
    t1 = span_clock()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    tol = 100_000                                   # 100 us
    (i,) = [i for i, s in enumerate(st.spans) if s[0].startswith("EXPAND(")]
    _, a, b, _ = st.spans[i]
    mine = [e for e in events if e[0] == "aten::repeat_interleave"]
    assert mine, sorted({e[0] for e in events})
    for _, ea, eb in mine:
        assert a - tol <= ea and eb <= b + tol, (a, b, ea, eb)
    # and every aten event of the run lies inside the run's root span
    _, ra, rb, _ = st.spans[0]
    for n, ea, eb in events:
        if n.startswith("aten::") and t0 <= ea <= t1:
            assert ra - tol <= ea and eb <= rb + tol, n


@pytest.mark.parametrize("name,syncs,phases", [
    # SCAN's filter (nonzero); the name column delivered
    ("point", 2, {"pattern:sync": 1, "deliver:sync": 1}),
    # SCAN's filter, the fused chain's control read; one column
    ("chain", 3, {"pattern:sync": 2, "deliver:sync": 1}),
    # two filtered scans, two chains, the join's pair count; the group
    # count; one column
    ("join", 7, {"pattern:sync": 5, "tail:sync": 1, "deliver:sync": 1}),
])
def test_host_syncs_pinned_by_plan_shape(gopt, name, syncs, phases):
    text, params = QUERIES[name]
    _, st = gopt.run(text, params)
    assert st.host_syncs == syncs
    assert {k: v["calls"] for k, v in st.transfers.items()
            if k.endswith(":sync")} == phases
    # the residency invariant still reads d2h alone
    assert TransferStats.mid_plan_d2h(st.transfers) == 0
    assert st.transfers["deliver:d2h"]["calls"] == phases["deliver:sync"]


# PROFILE as the engine printed it before its times came from spans (times
# masked)
PROFILE_TAIL = """-- physical plan --
  ExpandChain(+f+h) [est=22.1 cost=54.6 act=24 time=Xms]
    Scan(p) [est=1 cost=1 act=1 time=Xms]
-- relational tail --
  GROUP rows=19 time=Xms
result: 5 rows in Xms"""


@pytest.mark.parametrize("mode", ["PROFILE", "PROFILE SYNC"])
def test_profile_output_is_unchanged(gopt, mode):
    text, params = TAIL
    out = re.sub(r"\d+\.\d+ms", "Xms", gopt.run(f"{mode} {text}",
                                                params).render())
    assert out.startswith(f"{mode} (backend=torch[cpu], compile=Xms)")
    assert out.endswith(PROFILE_TAIL)


def test_profile_sync_counts_its_barriers(gopt):
    text, params = TAIL
    _, plain = gopt.run(text, params)
    rep = gopt.run(f"PROFILE SYNC {text}", params)
    # one block_ready per logged operator (SCAN, EXPANDCHAIN, GROUP)
    pq = gopt.prepare(text, params)
    _, st = pq.execute(params, sync_per_op=True)
    assert st.host_syncs == plain.host_syncs + len(st.op_rows)
    assert rep.result_rows == 5


def test_batch_runs_keep_spans_one_to_one(gopt):
    text, _ = CHAIN
    pq = gopt.prepare(text, {"x": 3})
    for tbl, st in pq.execute_many([{"x": 3}, {"x": 5}, {"x": 9}]):
        assert [st.spans[i][0] for i in st.op_spans] == \
            [n for n, _ in st.op_rows]
        assert len(st.op_times) == len(st.op_rows)
        assert st.host_syncs > 0


def test_execute_gets_a_root_of_its_own(gopt):
    pq = gopt.prepare(*POINT)
    _, st = gopt.execute(pq.opt, params=POINT[1])
    assert [s[0] for s in st.spans if s[3] == -1] == ["gopt.execute"]
    assert [st.spans[i][0] for i in _children(st.spans, 0)] == \
        ["engine.setup", "pattern", "tail", "deliver"]


def test_a_replan_on_binding_skew_lies_in_the_plan_span():
    """The re-plan ``PreparedQuery.execute`` would make on a skewed
    binding is made inside ``plan``, not in the run's own time."""
    g = GOpt(generate_motivating(n_person=200, n_product=60, n_place=12),
             device="cpu")
    q = ("MATCH (a:PERSON)-[:knows]->(b:PERSON) WHERE a.id IN $S "
         "RETURN a.id AS aid, b.id AS bid ORDER BY aid, bid")
    g.run(q, {"S": [1]})
    replans = []
    inner = g._maybe_replan

    def timed(pq, params):
        t0 = span_clock()
        out = inner(pq, params)
        if out is not pq:
            replans.append((t0, span_clock()))
        return out

    g._maybe_replan = timed
    _, st = g.run(q, {"S": list(range(200))})
    assert g.plan_cache_info()["replans"] == 1 and len(replans) == 1
    (plan,) = [s for s in st.spans if s[0] == "plan"]
    assert plan[1] <= replans[0][0] and replans[0][1] <= plan[2]


def test_exec_stats_close_renames_and_counts_syncs():
    ts = TransferStats()
    m = ts.mark()
    st = ExecStats()
    root = st.open("root")
    op = st.open()
    ts.set_phase("pattern")
    ts.sync()
    ts.sync()
    st.log("OP", 3, op)
    ts.set_phase("deliver")
    ts.sync()
    ts.record("d2h", 5)
    step = st.open("STEP")
    st.end(step)
    st.end(step)                      # a second end leaves it as it was
    st.close(root)
    assert [(s[0], s[3]) for s in st.spans] == \
        [("root", -1), ("OP", 0), ("STEP", 0)]
    assert all(s[2] >= s[1] > 0 for s in st.spans)
    st.transfers = ts.summary(m)
    assert st.host_syncs == 3
    assert st.transfers["pattern:sync"]["calls"] == 2
    assert st.op_rows == [("OP", 3)] and st.rows_produced == 3
    fork = st.fork()
    assert fork.spans == st.spans and fork.spans is not st.spans


def test_ledgers_stay_bounded_and_held_marks_still_read(gopt):
    ops = gopt.spec.operators(gopt.store)
    ts, ks = ops.transfer_stats, ops.kernel_stats
    ts.reset()
    ks.reset()
    for _ in range(3):
        gopt.run(*CHAIN)
    # small ledgers are kept whole between runs, as before
    assert len(ts.events) == ts.mark() > 0
    held = ts.hold()
    for _ in range(4):
        gopt.run(*CHAIN)
    per_run = (ts.mark() - held) // 4
    assert ts.count("sync", since=held) == 4 * 3
    old = (ts.KEEP, ks.KEEP)
    ts.KEEP = ks.KEEP = 2 * per_run
    try:
        for _ in range(10):             # the hold keeps every event
            gopt.run(*CHAIN)
        assert ts.count("sync", since=held) == 14 * 3
        ts.release(held)
        for _ in range(50):
            gopt.run(*CHAIN)
            assert len(ts.events) <= 4 * per_run + per_run
        # a plain mark is a read: it neither holds the list nor loses the
        # events of the run after it
        plain = ts.mark()
        _, st = gopt.run(*CHAIN)
        assert st.host_syncs == 3 == ts.count("sync", since=plain)
        for _ in range(10):
            gopt.run(*CHAIN)
        assert len(ts.events) <= 5 * per_run
        with pytest.raises(ValueError, match="dropped"):
            ts.summary(plain)
    finally:
        ts.KEEP, ks.KEEP = old


def test_a_failed_run_releases_its_marks(gopt):
    ops = gopt.spec.operators(gopt.store)
    ts = ops.transfer_stats
    ts.reset()
    with pytest.raises(RuntimeError, match="intermediate blow-up"):
        gopt.run(CHAIN[0], CHAIN[1], max_rows=2)
    assert ts._held == []


def test_release_after_reset_is_harmless():
    ts = TransferStats()
    m = ts.hold()
    ts.record("d2h", 4)
    ts.reset()
    ts.release(m)
    assert ts.events == [] and ts._held == [] and ts.mark() == 0


def test_a_wave_reads_its_dispatches_while_its_runs_trim(gopt):
    """The server holds its wave's kernel ledger: the runs inside it
    release theirs, and trimming waits for the wave's summary."""
    ks = gopt.spec.operators(gopt.store).kernel_stats
    old = ks.KEEP
    ks.KEEP = 1
    try:
        srv = gopt.serve(max_wave=4, overlap=False)
        reqs = [srv.submit(CHAIN[0], {"x": x}) for x in range(4)]
        while srv.pending:
            srv.step()
        srv.close()
    finally:
        ks.KEEP = old
    assert all(r.status == "done" for r in reqs)
    assert srv.stats.waves >= 1 and ks._held == []
    assert len(ks.events) == 1           # trimmed once the wave released
