"""Room for a new deployment: a system that serves data of its own (no
``generator_scale``), a mix whose queries file holds a read that
``queries.json`` does not, a driver with its own plain reference, and a
per-layer reader (``tests/room/``) are added to a copy of the benchmark
with their ``BENCHMARK.json`` entries.  In fresh processes on the CPU, the
cell runs correct through ``harness.run_cell``, its control comes out not
correct through ``harness.run_control`` on the data the system served,
and the copy's own spec and line tests pass over it (``pytest -k room``);
no file the benchmark had is edited."""
import json
import os
import re
import shutil
import subprocess
import sys

import _paths  # noqa: F401
import pytest

from perfbench import bench, harness

ROOM = bench.BENCH_DIR / "tests" / "room"
CELL = "room.one_client"
# what a new deployment adds: a system, a driver, a configuration, a mix,
# its queries and a reader
ADDED = (("room_system.py", "room_system.py"),
         ("room_driver.py", "room_driver.py"),
         ("room.json", "configs/room.json"),
         ("room_traffic.json", "traffic/room_one.json"),
         ("room_queries.json", "room_queries.json"),
         ("room.latency_p50_ms.py", "metrics/room.latency_p50_ms.py"))
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness, room_driver, room_system, snb
sizes = room_system.CPU_SIZES
print(json.dumps(harness.run_cell({cell!r}, 5, 0.2, False, 0.0,
                                  device="cpu", sizes=sizes)))
print(json.dumps(harness.run_control({cell!r}, 5, sizes=sizes)))
print(json.dumps(room_driver.fingerprint(
    snb.generate(sizes["room_scale"], 5))))
"""


@pytest.fixture(scope="module")
def bench_copy(tmp_path_factory):
    """The benchmark with the room's files and entries added: the copy's
    root, and the bytes of every file the benchmark had."""
    root = tmp_path_factory.mktemp("bench_copy")
    dst = root / "perfbench"
    shutil.copytree(bench.BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    had = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    for src, to in ADDED:
        shutil.copy(ROOM / src, dst / to)
    spec = bench.load()
    spec["configs"].append({"name": "room", "source": "a test",
                            "file": "perfbench/configs/room.json",
                            "reduced": [], "why": "the room test"})
    spec["workloads"].append({"name": CELL, "config": "room",
                              "traffic": "room_one", "chips": 1,
                              "why": "the room test"})
    spec["per_layer"].append({"name": "room.latency_p50_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "engine", "moves": "latency_p99_ms",
                              "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root, had


def _unedited(had):
    return [str(p) for p, b in had.items() if p.read_bytes() != b]


def test_a_cell_with_its_own_data_and_queries_runs_with_no_edit(bench_copy):
    root, had = bench_copy
    code = PROBE.format(root=str(root), src=str(_paths.ROOT / "src"),
                        cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    line, control, frozen = map(json.loads,
                                out.stdout.strip().splitlines()[-3:])
    assert line["correct"], line["checks"]
    # each read had a pid of its own, and each was checked with it
    assert line["notes"]["bindings_checked"] > 1
    assert line["notes"]["answers_checked"] == line["attempted"]
    assert set(line["metrics"]) == {"cgp_ms_per_query", "setup_s",
                                    "latency_p99_ms"}
    assert line["notes"]["latency_samples"] == line["attempted"]
    assert not control["correct"], control["checks"]
    # the control was built and checked on the data the system served,
    # which the frozen generator does not give
    assert control["notes"]["raw_fingerprint"] == \
        line["notes"]["raw_fingerprint"] != frozen
    assert "generator_scale" not in json.loads(
        (ROOM / "room.json").read_text())
    assert "fof_count" not in harness.queries()
    assert _unedited(had) == []


def test_the_copys_spec_and_line_tests_pass_over_the_room_cell(bench_copy):
    root, had = bench_copy
    env = dict(os.environ, PYTHONPATH=str(_paths.ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "room",
         "perfbench/tests/test_perfbench_spec.py",
         "perfbench/tests/test_perfbench_line.py"],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    passed = set(re.findall(r"^PASSED (\S+)", out.stdout, re.M))
    assert passed == {
        f"perfbench/tests/test_perfbench_spec.py::{t}" for t in (
            f"test_harness_finds_the_cell_its_config_mix_and_metrics[{CELL}]",
        )} | {
        f"perfbench/tests/test_perfbench_line.py::{t}" for t in (
            f"test_result_line_has_the_contract_keys_checks_last[{CELL}]",
            f"test_control_is_not_correct[{CELL}]",
            f"test_a_fault_under_the_timed_path_is_not_correct"
            f"[{CELL}-_alter_answers]",
            f"test_a_failure_other_than_the_guard_ends_the_run[{CELL}]")}
    assert _unedited(had) == []
