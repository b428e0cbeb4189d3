"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's file
is ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), the mix's
is ``traffic/<traffic>.json``, and each metric's reader is
``metrics/<metric name>.py`` (``read(run)``: a number, or None where the
run has nothing to read).

The configuration's optional ``"system"`` key names the module
``perfbench/<system>.py`` of the system under test (default ``system``):
``data(config, seed)`` makes the raw data it serves from the seed (the
control and the reference are built on the same), ``build(config, seed,
device)`` builds the system over it, keeping that data as ``raw``, and
``CPU_SIZES`` holds the configuration keys that shrink it for the CPU
tests.  The mix's optional ``"queries_file"`` key names its queries, a
path under ``perfbench/`` (default ``queries.json``), and its optional
``"driver"`` key the module ``perfbench/<driver>.py`` that drives the
system and checks what it answered (default ``closed_loop``): ``run``,
whose record carries ``latencies_ms``, one time from send to answer per
request completed in the window; ``check`` and ``control_record``, which
take the system's ``raw``, whatever its type.
Adding a cell, a mix, a system, a driver or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load() -> dict:
    return json.loads(BENCHMARK.read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in {BENCHMARK.name}")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in {BENCHMARK.name}")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def metrics(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on.  A metric with
    no ``workloads`` key belongs to every cell."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def module(name: str):
    """The module ``perfbench/<name>.py`` (a system or a driver)."""
    return importlib.import_module(f"perfbench.{name}")
