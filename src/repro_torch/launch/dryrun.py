"""Multi-pod dry run, the port of ``src/repro/launch/dryrun.py``.

For every (architecture x input-shape x mesh) cell: build the production
mesh (abstract: axis names and sizes), the step's arguments on the meta
device and their shardings, then run the step once on ``meta`` under the
roofline counter (``launch/roofline.py``) with the bundle's hint table
installed.  Where the reference lowers and compiles with XLA, the port
runs eagerly, so one meta run stands for ``lower().compile()``: nothing is
allocated and no kernel launches (each kernel wrapper reports its own
work from its meta branch).

Per device, the record holds:
- ``arguments`` and ``outputs``: exact, the shard shapes of every leaf
  under the cell's shardings (a shape that does not divide fails the cell,
  as jax's ``shard_shape`` does);
- ``temps``: an estimate (``temps_method``), the high-water mark of live
  meta storage during the run divided by the mesh's devices;
- the roofline terms of the whole step's counted work, split evenly over
  the devices, with ZeRO-1's collectives in a training step.

Unlike the reference, the module sets no environment variable at import,
so tests may import it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape prefill_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

from repro_torch.configs import get_bundle, list_archs
from repro_torch.configs.base import (dp_axes, mesh_axes, mesh_size,
                                      reference_specs, shard_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (Counter, summarize, terms_of,
                                         zero1_collectives)
from repro_torch.models.sharding import hint_context

TEMPS_METHOD = ("estimate: peak live meta storage of one run of the whole "
                "step, divided by the mesh's devices")


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh_axes(mesh).values())


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             with_roofline: bool = True, *, bundle=None, mesh=None) -> dict:
    """One cell.  ``bundle`` (default ``get_bundle(arch)``) and ``mesh``
    (default the production mesh) may be given, e.g. a smoke bundle, a
    bundle whose shape dims were cut, or a ``(1, 1)`` host mesh."""
    t0 = time.time()
    bundle = bundle or get_bundle(arch)
    spec = bundle.shapes[shape]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mesh),
           "kind": spec.kind}
    if spec.skip:
        rec["status"] = "SKIPPED"
        rec["reason"] = spec.skip
        return rec
    try:
        step = bundle.make_step(shape)
        args = bundle.input_specs(shape)
        in_sh, out_sh, hints = bundle.shardings(mesh, shape)
        arg_specs = reference_specs(args)
        arguments = shard_bytes(arg_specs, in_sh)
        t_setup = time.time() - t0
        counter = Counter()
        with hint_context(hints) as seen, counter:
            out = step(*args)
            out_specs = reference_specs(_as_tuple(out))
            del out
        t_run = time.time() - t0 - t_setup
        devices = mesh_size(mesh)
        outputs = shard_bytes(out_specs, _as_tuple(out_sh))
        temps = counter.peak_live // devices
        rec.update({
            "status": "OK",
            "setup_s": round(t_setup, 2),
            "run_s": round(t_run, 2),
            "bytes_per_device": {
                "arguments": int(arguments),
                "outputs": int(outputs),
                "temps": int(temps),
                "temps_method": TEMPS_METHOD,
                "total_gb": round((arguments + outputs + temps) / 2**30, 3),
            },
            "counted": {"flops": counter.total_flops(),
                        "bytes": counter.bytes,
                        "peak_live_bytes": counter.peak_live},
            "hints": seen,
        })
        if with_roofline:
            terms = terms_of(counter, devices)
            if spec.kind == "train":
                axes = mesh_axes(mesh)
                zero1_collectives(terms, arg_specs[0], in_sh[0],
                                  in_sh[1].mu,
                                  math.prod(axes[a] for a in dp_axes(mesh)))
            mf = bundle.model_flops(shape)
            rec["roofline"] = summarize(terms, mf / devices if mf else 0.0)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    for arch in archs:
        bundle = get_bundle(arch)
        shapes = ([args.shape] if args.shape else bundle.shape_names())
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               with_roofline=not args.no_roofline)
                results.append(rec)
                status = rec["status"]
                extra = ""
                if status == "OK":
                    extra = (f"mem={rec['bytes_per_device']['total_gb']}GB "
                             f"run={rec['run_s']}s")
                    if "roofline" in rec:
                        r = rec["roofline"]
                        extra += (f" dom={r['dominant']}"
                                  f" Tc={r['t_compute_s']:.3g}"
                                  f" Tm={r['t_memory_s']:.3g}"
                                  f" Tx={r['t_collective_s']:.3g}")
                elif status == "FAIL":
                    extra = rec["error"][:200]
                else:
                    extra = rec["reason"][:80]
                print(f"[{status:7s}] {arch:22s} {shape:14s} "
                      f"{rec['mesh']:8s} {extra}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"{len(results)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
