"""``BENCHMARK.json`` against the contract's shape, and the harness
finding every cell, mix and metric by name."""
import json
import re

import _paths  # noqa: F401
import pytest

from perfbench import bench, harness

SPEC = json.loads(bench.BENCHMARK.read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(bench.BENCHMARK.read_bytes()) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (bench.ROOT / p).is_dir()
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


def test_every_name_and_unit_meets_the_character_rule():
    for c in SPEC["configs"]:
        assert bench.NAME.match(c["name"])
        assert all(bench.NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    for w in SPEC["workloads"]:
        for k in ("name", "config", "traffic"):
            assert bench.NAME.match(w[k]), w[k]
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in METRICS:
        assert bench.NAME.match(m["name"]), m["name"]
        assert bench.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_the_cell_its_config_mix_and_metrics(cell):
    w = bench.cell(SPEC, cell)
    cfg = bench.config(SPEC, w["config"])
    trf = bench.traffic(w["traffic"])
    sut = harness.system(cfg)
    for fn in ("build", "data"):
        assert callable(getattr(sut, fn))
    assert sut.CPU_SIZES and set(sut.CPU_SIZES) <= set(cfg) | set(trf)
    if sut.__name__ == "perfbench.system":
        assert cfg["generator_scale"] > 0
    assert trf["queries"]
    e2e = bench.metrics(SPEC, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert bench.metrics(SPEC, cell, trace=True)
    for m in e2e + bench.metrics(SPEC, cell, trace=True):
        assert callable(bench.reader(m["name"]))
    qfile = bench.BENCH_DIR / trf.get("queries_file", "queries.json")
    assert qfile.resolve().is_relative_to(bench.BENCH_DIR)
    qs = harness.queries(trf)
    for name in trf["queries"]:
        assert name in qs
    drv = harness.driver(trf)
    for fn in ("run", "check", "control_record"):
        assert callable(getattr(drv, fn))


def test_each_config_file_is_under_paths_and_its_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in SPEC["paths"])
        assert (bench.ROOT / f).is_file()
