"""One run of one cell: build the system, drive the window, read the
metrics, check the answers, and assemble the result line.  The system
and the driver are the modules the configuration and the mix name
(``bench.module``), and the queries come from the mix's queries file."""
from __future__ import annotations

import gc
import json
import sys
import time

from perfbench import bench
from perfbench.trace import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def queries(traffic: dict | None = None) -> dict:
    """The queries of the mix's ``"queries_file"`` (a path under
    ``perfbench/``; ``queries.json`` without the key or a mix)."""
    name = (traffic or {}).get("queries_file", "queries.json")
    return json.loads((bench.BENCH_DIR / name).read_text())["queries"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def system(config: dict):
    """The configuration's system module (``data``, ``build``,
    ``CPU_SIZES``); with no ``"system"`` key, ``system``."""
    return bench.module(config.get("system", "system"))


def driver(traffic: dict):
    """The mix's driver module (``run``, ``check``, ``control_record``);
    with no ``"driver"`` key, the closed loop."""
    return bench.module(traffic.get("driver", "closed_loop"))


def device_record(device: str | None, trace_summary) -> dict:
    if device is None:
        import torch
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        out = {"platform": device, "kind": device, "count": 0,
               "memory_peak_bytes": 0}
    if trace_summary is not None:
        out["busy_s"] = trace_summary.busy_s
        out["window_s"] = trace_summary.window_s
    return out


def _setup(cell_name: str, sizes: dict | None):
    """The spec, the cell's configuration and its mix, with ``sizes``
    (keys of the configuration or the mix) replaced."""
    spec = bench.load()
    cell = bench.cell(spec, cell_name)
    cfg = bench.config(spec, cell["config"])
    trf = bench.traffic(cell["traffic"])
    for key, value in (sizes or {}).items():
        (cfg if key in cfg else trf)[key] = value
    return spec, cfg, trf


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str | None = None,
             sizes: dict | None = None) -> dict:
    """The result line of one run (``t_process``: the process's start on
    the ``time.perf_counter`` clock).  ``device="cpu"`` and ``sizes``
    (keys of the configuration and the traffic file replaced) are for the
    CPU tests; a run on the card takes neither."""
    spec, cfg, trf = _setup(cell_name, sizes)
    qs = queries(trf)
    rec = Recorder(trace)
    drv = driver(trf)
    sut = system(cfg).build(cfg, seed, device)
    record = drv.run(sut, cfg, trf, qs, seed, seconds, rec)
    record["setup_s"] = rec.first_timed - t_process
    record["glogue_s"] = sut.glogue_s
    record["generate_s"] = sut.generate_s
    record["trace"] = rec.summary()
    record["traced_done"] = rec.traced_done
    dev = device_record(device, record["trace"])
    metrics = {}
    for m in bench.metrics(spec, cell_name, trace):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    raw = sut.raw
    del sut            # the program's state goes before the reference runs
    gc.collect()
    t0 = time.perf_counter()
    checks, notes = drv.check(record, raw, qs)
    notes["reference_s"] = time.perf_counter() - t0
    notes["window_s"] = record["window_s"]
    notes["generate_s"] = record["generate_s"]
    lat = record["latencies_ms"]
    p99 = bench.reader("latency_p99_ms")(record)
    notes["latency_samples"] = len(lat)
    notes["latency_beyond_p99"] = sum(x > p99 for x in lat)
    if trace:
        notes["trace_read_s"] = rec.stop_s
    notes.update(record.get("notes", {}))
    line = {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": dev}
    if record["trace"] is not None:
        line["breakdown"] = record["trace"].breakdown()
    line["notes"] = notes
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def run_control(cell_name: str, seed: int,
                sizes: dict | None = None) -> dict:
    """The control in the system's place (the driver's
    ``control_record``), through the same comparison, on the data the
    system serves (its module's ``data``); ``sizes`` as in ``run_cell``."""
    _, cfg, trf = _setup(cell_name, sizes)
    qs = queries(trf)
    drv = driver(trf)
    raw = system(cfg).data(cfg, seed)
    t0 = time.perf_counter()
    record = drv.control_record(raw, trf, qs, seed)
    checks, notes = drv.check(record, raw, qs)
    return {"control": True, "cell": cell_name, "seed": seed,
            "correct": all(v <= lim for _, v, lim in checks),
            "seconds": time.perf_counter() - t0, "notes": notes,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}}
