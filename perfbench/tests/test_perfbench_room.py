"""Room for a new deployment: a configuration and a mix that name a system
module and a driver module of their own (``tests/room/``) run through
``harness.run_cell`` and ``harness.run_control`` once their files and
``BENCHMARK.json`` entries are added to a copy of the benchmark, in a
fresh process on the CPU, and no file the benchmark had is edited."""
import json
import shutil
import subprocess
import sys

import _paths  # noqa: F401

from perfbench import bench

ROOM = bench.BENCH_DIR / "tests" / "room"
CELL = "room.one_client"
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness
print(json.dumps(harness.run_cell({cell!r}, 5, 0.2, False, 0.0,
                                  device="cpu")))
print(json.dumps(harness.run_control({cell!r}, 5)))
"""


def test_a_new_system_and_driver_run_with_no_edit(tmp_path):
    dst = tmp_path / "perfbench"
    shutil.copytree(bench.BENCH_DIR, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    had = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    # what a new deployment adds: a system, a driver, a configuration, a mix
    for src, to in (("room_system.py", "room_system.py"),
                    ("room_driver.py", "room_driver.py"),
                    ("room.json", "configs/room.json"),
                    ("room_traffic.json", "traffic/room_one.json")):
        shutil.copy(ROOM / src, dst / to)
    spec = bench.load()
    spec["configs"].append({"name": "room", "source": "a test",
                            "file": "perfbench/configs/room.json",
                            "reduced": [], "why": "the room test"})
    spec["workloads"].append({"name": CELL, "config": "room",
                              "traffic": "room_one", "chips": 1,
                              "why": "the room test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = PROBE.format(root=str(tmp_path), src=str(_paths.ROOT / "src"),
                        cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    line, control = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert line["correct"], line["checks"]
    assert line["notes"]["system"] == "perfbench.room_system"
    # each read had a pid of its own, and each was checked with it
    assert line["notes"]["bindings_checked"] > 1
    assert line["notes"]["answers_checked"] == line["attempted"]
    assert set(line["metrics"]) == {"cgp_ms_per_query", "setup_s"}
    assert not control["correct"], control["checks"]
    assert all(p.read_bytes() == b for p, b in had.items())
