"""``perfbench/attribution.py``: idle gaps put down to the innermost program
span, on a synthetic trace with nested spans; the accepted readers and
``Summary`` read the same record as before; and a CPU run through the tap
sums the program's host syncs."""
import _paths  # noqa: F401
import pytest

from perfbench import attribution, bench, harness, trace


def _record(rec):
    """The synthetic window of ``test_perfbench_line``'s trace test, with
    one ``GOpt.run`` span tree inside each query."""
    rec.windows = [(0, 100)]
    rec.spans = [("query a", 0, 40), ("query b", 45, 100)]
    rec._events = [("void (anonymous namespace)::fence_kernel<6>(int)", 10,
                    20, "kernel"), ("x", 15, 30, "kernel"),
                   ("Memcpy DtoH", 50, 60, "copy"), ("late", 80, 90, "kernel")]
    rec._trace_end = 70
    return rec


# (name, start, end, parent): ExecStats.spans of two runs
RUN_A = [("gopt.run", 1, 38, -1), ("plan", 1, 4, 0),
         ("engine.setup", 4, 5, 0), ("pattern", 5, 33, 0),
         ("SCAN(p)", 5, 12, 3), ("FILTER", 6, 9, 4),
         ("EXPAND(+f|1e)", 12, 33, 3), ("tail", 33, 34, 0),
         ("deliver", 34, 38, 0)]
RUN_B = [("gopt.run", 46, 68, -1), ("plan", 46, 47, 0),
         ("engine.setup", 47, 48, 0), ("pattern", 48, 62, 0),
         ("JOIN(c)", 49, 62, 3), ("tail", 62, 63, 0),
         ("deliver", 63, 68, 0)]


def test_innermost_span_takes_each_gap():
    spans = (attribution.span_layers(RUN_A, "a")
             + attribution.span_layers(RUN_B, "b"))
    rec = _record(trace.Recorder(False))
    traced = [(0, 70)]
    out = attribution.attribute(rec._events, traced, rec.spans, spans)
    idle = out["idle_s"]
    # gaps: (0, 10) mid 5 in SCAN(p) (FILTER starts at 6); (30, 50) mid 40
    # in query a outside gopt.run; (60, 70) mid 65 in b's deliver
    assert idle["ops"] == pytest.approx(10e-9)
    assert idle[attribution.OUTSIDE] == pytest.approx(20e-9)
    assert idle["engine"] == pytest.approx(10e-9)
    assert idle["optimizer"] == 0.0 and idle[attribution.BETWEEN] == 0.0
    assert out["idle_by_op"] == [["SCAN(p)", pytest.approx(10e-9)]]
    assert out["idle_by_query_op"] == [["a SCAN(p)", pytest.approx(10e-9)]]
    assert sum(idle.values()) == pytest.approx(out["window_s"]
                                               - out["busy_s"])


def test_layers_follow_the_tree():
    layers = {s[0]: s[3] for s in attribution.span_layers(RUN_A)}
    assert layers == {"gopt.run": "engine", "plan": "optimizer",
                      "engine.setup": "engine", "pattern": "engine",
                      "SCAN(p)": "ops", "FILTER": "ops",
                      "EXPAND(+f|1e)": "ops", "tail": "engine",
                      "deliver": "engine"}


@pytest.mark.parametrize("mid,where", [
    (2, "optimizer"), (20, "ops"), (7, "ops"), (35, "engine"),
    (39, attribution.OUTSIDE), (42, attribution.BETWEEN),
    (56, "ops"), (99, attribution.BETWEEN)])
def test_one_gap_lands_where_its_midpoint_is(mid, where):
    spans = (attribution.span_layers(RUN_A, "a")
             + attribution.span_layers(RUN_B, "b"))
    out = attribution.attribute([], [(mid, mid + 1)],
                                [("query a", 0, 40), ("query b", 45, 70)],
                                spans)
    assert [k for k, v in out["idle_s"].items() if v] == [where]


def test_accepted_readers_and_summary_read_the_same_record():
    """A ``SpanRecorder`` holding program spans gives the accepted readers
    and ``breakdown`` what a plain ``Recorder`` gives."""
    plain = _record(trace.Recorder(False))
    spanned = _record(attribution.SpanRecorder(False))
    spanned.program_spans = (attribution.span_layers(RUN_A, "a")
                             + attribution.span_layers(RUN_B, "b"))
    a, b = plain.summary(), spanned.summary()
    assert a == b and a.breakdown() == b.breakdown()
    spec = bench.load()
    cell = spec["workloads"][0]["name"]
    for m in bench.metrics(spec, cell, trace=True):
        read = bench.reader(m["name"])
        run = {"trace": a, "traced_done": 2, "queries_done": 2,
               "rows_produced": 10, "prepare_ms": [1.0], "glogue_s": 1.0}
        assert read(run) == read(dict(run, trace=b)), m["name"]
    att = spanned.attribution()
    assert sum(att["idle_s"].values()) == pytest.approx(a.window_s
                                                        - a.busy_s)
    # the state it reads is what summary() reads: the same window and
    # busy time, from the same events
    assert (att["window_s"], att["busy_s"]) == (a.window_s, a.busy_s)
    events, windows = spanned.traced()
    assert trace.summarize(events, windows, spanned.spans) == a
    assert trace.Recorder(False).summary() is None
    assert attribution.SpanRecorder(False).traced() is None


def test_a_cpu_run_through_the_tap_counts_host_syncs():
    cell = bench.load()["workloads"][0]["name"]
    line = attribution.run_cell(cell, 5, 0.3, False, device="cpu",
                                sizes={"generator_scale": 0.25})
    assert line["queries_done"] > 0
    assert line["host_syncs_per_query"] > 0
    assert sum(line["host_syncs_by_phase"].values()) == \
        pytest.approx(line["host_syncs_per_query"])
    assert set(line["host_syncs_by_query"]) <= set(harness.queries())
    assert "traced_done" not in line          # untraced: counts only

