"""A run's result line, its imports, and the controls.

Each cell's driver runs a short window on the CPU at its system's
``CPU_SIZES``; the line must carry exactly the contract's keys, ``checks``
last.
Nothing the run loads may be JAX or the JAX package (checked in a fresh
process); the reference loads nothing of the port; without a card
``run.py`` exits non-zero and prints no result.  Each cell's control (the
reference with one guarantee broken, from the cell's driver, on the
data the cell's system serves) and each
fault planted under the timed path that the cell's driver can meet must
come out not correct, and a failure other than the engine's guard must
end the run.
"""
import json
import subprocess
import sys

import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench import bench, harness

SEED = 5
ROOT = _paths.ROOT
CELLS = [w["name"] for w in bench.load()["workloads"]]


def _sizes(cell):
    """The cell's system's ``CPU_SIZES``."""
    spec = bench.load()
    cfg = bench.config(spec, bench.cell(spec, cell)["config"])
    return harness.system(cfg).CPU_SIZES


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, 0.0, device="cpu",
                            sizes=_sizes(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contract_keys_checks_last(cell):
    line = _run(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "notes", "checks"}
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {
        m["name"] for m in bench.metrics(bench.load(), cell, trace=False)}
    assert "latency_p99_ms" in line["metrics"]
    assert 0 <= line["notes"]["latency_beyond_p99"] < \
        line["notes"]["latency_samples"]
    assert {"wrong_answers", "failed_requests"} <= set(line["checks"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
"""


def _fresh(body: str) -> str:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    found = _fresh(
        "from perfbench import harness\n"
        f"harness.run_cell({CELLS[0]!r}, 5, 0.1, False, 0.0,"
        " device='cpu', sizes={'generator_scale': 0.25})\n"
        "print(harness.forbidden_modules() + sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro')))")
    assert found == "[]"


def test_the_reference_loads_nothing_of_the_port():
    found = _fresh(
        "import perfbench.check, perfbench.reference.suite, "
        "perfbench.snb\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'repro_torch', 'repro', 'jax', 'torch'}))")
    assert found == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    assert out.returncode != 0
    assert "correct" not in out.stdout


def _traffic(cell):
    return bench.traffic(bench.cell(bench.load(), cell)["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = harness.run_control(cell, SEED, sizes=_sizes(cell))
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]
    assert not out["correct"]


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: every integer column the
    engine delivers, one larger (one binding's run or a batch's)."""
    from repro_torch.graphdb import engine

    def bump(tbl):
        for k, v in tbl.cols.items():
            a = np.asarray(v)
            if a.dtype.kind == "i" and a.size:
                tbl.cols[k] = a + 1
        return tbl

    run, run_batch = engine.Engine.run, engine.Engine.run_batch
    monkeypatch.setattr(engine.Engine, "run", lambda self, *a, **k: (
        lambda r: (bump(r[0]), r[1]))(run(self, *a, **k)))
    monkeypatch.setattr(engine.Engine, "run_batch", lambda self, *a, **k: [
        (bump(t), st) for t, st in run_batch(self, *a, **k)])


def _fail_half(monkeypatch, message="intermediate blow-up: planted",
               after=0):
    """Half of the queries left out: after the first ``after``, every
    second query the engine runs fails at once, with ``message``."""
    from repro_torch.graphdb import engine
    run, calls = engine.Engine.run, []

    def half(self, *a, **k):
        calls.append(1)
        if len(calls) > after and len(calls) % 2:
            raise RuntimeError(message)
        return run(self, *a, **k)

    monkeypatch.setattr(engine.Engine, "run", half)
    return calls


# the faults each driver's timed path can have; a later cell's driver
# keeps the faults only it can meet in a test file of its own
FAULTS = {"closed_loop": [_alter_answers, _fail_half]}


@pytest.mark.parametrize("cell,fault", [
    pytest.param(c, f, id=f"{c}-{f.__name__}") for c in CELLS
    for f in FAULTS.get(_traffic(c).get("driver", "closed_loop"),
                        [_alter_answers])])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    line = _run(cell)
    assert not line["correct"], line["checks"]


def _fail_in_window(monkeypatch, message):
    """Once the driver's set-up has ended (the recorder's window start),
    every second engine run or batch fails at once with ``message``.
    Returns the calls made and the count when the window started."""
    from repro_torch.graphdb import engine
    from perfbench import trace
    calls, warm = [], []
    start = trace.Recorder.window_starts

    def mark(self):
        warm.append(len(calls))
        start(self)

    def half(f):
        def run(self, *a, **k):
            calls.append(1)
            if warm and (len(calls) - warm[0]) % 2:
                raise RuntimeError(message)
            return f(self, *a, **k)
        return run

    monkeypatch.setattr(trace.Recorder, "window_starts", mark)
    for name in ("run", "run_batch"):
        monkeypatch.setattr(engine.Engine, name,
                            half(getattr(engine.Engine, name)))
    return calls, warm


@pytest.mark.parametrize("cell", CELLS)
def test_a_failure_other_than_the_guard_ends_the_run(cell, monkeypatch):
    """In the window (the driver's set-up runs clean)."""
    trf = _traffic(cell)
    calls, warm = _fail_in_window(monkeypatch,
                                  "CUDA error: an illegal memory access")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _run(cell)
    assert warm and len(calls) > warm[0]
    if "warm_passes" in trf:        # the closed loop: one run a query
        assert warm[0] == len(trf["queries"]) * trf["warm_passes"]


def test_trace_summary_covers_the_traced_part_and_names_idle_spans():
    from perfbench import trace
    rec = trace.Recorder(False)
    rec.windows = [(0, 100)]
    rec.spans = [("query a", 0, 40), ("query b", 45, 100)]
    rec._events = [("void (anonymous namespace)::fence_kernel<6>(int)", 10,
                    20, "kernel"), ("x", 15, 30, "kernel"),
                   ("Memcpy DtoH", 50, 60, "copy"), ("late", 80, 90, "kernel")]
    rec._trace_end = 70                  # the profiler stopped at 70
    s = rec.summary()
    assert s.window_s == pytest.approx(70e-9)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.kernels == 2
    assert s.kernel_seconds("k1") == pytest.approx(10e-9)
    # gaps (0, 10) and (30, 50) fall in query a, (60, 70) in query b
    assert s.idle_by_host == pytest.approx({"query a": 30e-9,
                                            "query b": 10e-9})
    assert [n for n, _ in s.breakdown()["device_ops"]][0] == "x"
