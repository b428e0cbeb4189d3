"""``latency_p99_ms``: the reader against ``numpy.percentile``, and the
closed loop's ``latencies_ms`` at generator scale 0.5: one sample per
query completed in the window, none for a query that failed."""
import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench import bench, closed_loop, harness, system, trace
from test_perfbench_line import _fail_half

SEED = 5


def test_reader_is_numpys_99th_percentile():
    read = bench.reader("latency_p99_ms")
    lat = np.random.default_rng(SEED).gamma(2.0, 2.0, size=1000).tolist()
    assert read({"latencies_ms": lat}) == np.percentile(lat, 99)
    assert read({"latencies_ms": [float(i) for i in range(1, 101)]}) == \
        pytest.approx(99.01)
    assert read({"latencies_ms": []}) is None


@pytest.fixture(scope="module")
def cell():
    """The first cell's system at its ``CPU_SIZES`` (generator scale
    0.5), with its configuration and mix."""
    spec = bench.load()
    w = spec["workloads"][0]
    cfg = dict(bench.config(spec, w["config"]), **system.CPU_SIZES)
    trf = bench.traffic(w["traffic"])
    assert "driver" not in trf and cfg["generator_scale"] == 0.5
    return system.build(cfg, SEED, "cpu"), cfg, trf


@pytest.mark.parametrize("fault", [None, _fail_half])
def test_one_latency_per_query_completed(cell, fault, monkeypatch):
    sut, cfg, trf = cell
    if fault:
        fault(monkeypatch)
    record = closed_loop.run(sut, cfg, trf, harness.queries(trf), SEED,
                             0.3, trace.Recorder(False))
    lat = record["latencies_ms"]
    assert len(lat) == record["queries_done"] > 0
    assert (record["failed"] > 0) == bool(fault)
    assert all(x > 0 for x in lat)
    assert sum(lat) <= 1e3 * record["window_s"]
