#!/usr/bin/env python3
"""Time the WCOJ probe kernel's ``fence`` route against named variants of
its source on the smoke's three probe sets, on one GPU.

    python3 scripts/wcoj_intersect_variants.py search fence_x2 node16

from the repository root, naming the variants to time beside the
committed source (``base``: the fence walk, 8-key nodes, 1 probe a
thread, rows of fewer than 32 keys binary-searched, registers bounded for
8 blocks an SM, 6 on CSRs of 2^22 keys or more).  Each variant is the
source with one design choice changed:

- ``search``: the committed source's ``search`` route, the binary search
  (the baseline);
- ``search_x4``: the binary search with 4 probes in flight a thread
  (interleaving without the fence walk);
- ``fence_x2`` / ``fence_x4``: the fence walk with 2 / 4 probes in flight
  a thread (registers unbounded);
- ``node4`` / ``node16``: the fence walk over 4-key (16-byte) / 16-key
  (64-byte) nodes, each walking an index built at that width;
- ``walk_all``: every row walked, short rows too;
- ``blocks6``: registers bounded for 6 blocks of 256 threads an SM on
  every CSR;
- ``wide8``: 8 blocks an SM on large CSRs too;
- ``no_compare``: an ablation, not a design: each level's compares cut to
  one, so the walk's other work is timed alone (its output is wrong and
  is not held to the plain version).

The probe sets are ``chip_smoke.py``'s: ``synthetic_zipf`` (its seeded
2^24-edge Zipf CSR and 2^24 probes) and the two GLogue intersect calls it
captures while ``GOpt`` builds its statistics over the sf=100 LDBC-like
store (``glogue_most_steps``, ``glogue_most_rows``), regenerated here the
same way.  A line per set describes it (rows sorted, the share of
32-probe groups on one row, probed degrees).  Each build but an ablation
is held against the plain version bit for bit on every set, then timed in turns after one discarded run (base, variants,
variants reversed, base) as the smoke times K1: batches of 10 calls queued
behind a device sleep.  Prints one JSON line per build, check and probe
set, and the card's name and power limit.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "wcoj_intersect" /
          "csrc" / "wcoj_intersect.cu")
BATCH, REPS, QUEUE_CYCLES = 10, 20, 4_000_000

# no register bound on the fence kernel (1 block an SM is no bound)
UNBOUNDED = [("constexpr int kBlocksL2 = 8;", "constexpr int kBlocksL2 = 1;"),
             ("constexpr int kBlocksWide = 6;",
              "constexpr int kBlocksWide = 1;")]
# name: (source edits, entry point, node width of the index it walks)
VARIANTS = {
    "search": ([], "search", None),
    "search_x4": ([("constexpr int kSearchProbes = 1;",
                    "constexpr int kSearchProbes = 4;")], "search", None),
    "fence_x2": ([("constexpr int kProbes = 1;",
                   "constexpr int kProbes = 2;"), *UNBOUNDED], "fence", 8),
    "fence_x4": ([("constexpr int kProbes = 1;",
                   "constexpr int kProbes = 4;"), *UNBOUNDED], "fence", 8),
    "node4": ([("constexpr int kNode = 8;", "constexpr int kNode = 4;")],
              "fence", 4),
    "node16": ([("constexpr int kNode = 8;", "constexpr int kNode = 16;")],
               "fence", 16),
    "walk_all": ([("constexpr int kSmallRow = 32;",
                   "constexpr int kSmallRow = 0;")], "fence", 8),
    "blocks6": ([("constexpr int kBlocksL2 = 8;",
                  "constexpr int kBlocksL2 = 6;")], "fence", 8),
    "wide8": ([("constexpr int kBlocksWide = 6;",
                "constexpr int kBlocksWide = 8;")], "fence", 8),
    "no_compare": ([("    m |= (k[q] < t ? 1u : 0u) << q;",
                     "    m |= (q == 0 && k[q] < t) ? 0xFFFFu : 0u;")],
                   "fence", 8),
}
ABLATIONS = {"no_compare"}


def build(name: str, text: str, entry: str, out_dir: Path):
    from repro_torch.kernels import _build
    src = out_dir / f"{name}.cu"
    lib = out_dir / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), f"wcoj_probe_{entry}")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, p, p, p, i64, i64, p, p, p]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in proc.stdout.splitlines() + proc.stderr
             .splitlines() if "registers" in ln or "spill" in ln]
    return fn, ptxas


def probe_sets(device) -> dict:
    """The smoke's three probe sets: ``{label: (indptr, indices, rows,
    targets, pos_map)}``."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.ldbc import generate_ldbc
    from repro_torch.graphdb.torch_backend import torch_spec
    sets = {"synthetic_zipf": cs.synthetic_probe(cs.SEED, device)[:5]}
    store = generate_ldbc(sf=cs.SF, seed=7)
    ops = torch_spec("cuda").operators(store)
    calls = cs.capture_glogue(ops)
    GOpt(store)
    torch.cuda.synchronize()
    del ops.intersect
    for label, args in cs.glogue_probes(ops, calls).items():
        sets[label] = args[:5]
    return sets


def describe(indptr, rows) -> dict:
    """Rows sorted?  The share of 32-probe groups whose probes share one
    row, and the probed rows' degree quantiles."""
    import torch
    r = rows.to(torch.int64)
    m = r.shape[0] // 32 * 32
    groups = r[:m].view(-1, 32)
    deg = (indptr[r + 1] - indptr[r]).to(torch.float64)
    q = torch.tensor([0.5, 0.9], dtype=torch.float64, device=deg.device)
    p50, p90 = torch.quantile(deg[:1 << 24], q).tolist()
    return {"rows_sorted": bool((r[1:] >= r[:-1]).all()),
            "groups_on_one_row": float((groups == groups[:, :1]).all(1)
                                       .to(torch.float64).mean()),
            "probe_degree_p50": p50, "probe_degree_p90": p90}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wcoj_intersect_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.wcoj_intersect.ops import build_search_index
    from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chosen = sys.argv[1:]
    unknown = sorted(set(chosen) - set(VARIANTS))
    if not chosen or unknown:
        print(f"wcoj_intersect_variants: name variants among "
              f"{sorted(VARIANTS)} (unknown: {unknown})", file=sys.stderr)
        return 2
    base = SOURCE.read_text()
    plans = {"base": (base, "fence", 8)}
    for name in chosen:
        edits, entry, node = VARIANTS[name]
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        plans[name] = (text, entry, node)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, (text, entry, _) in plans.items():
            fns[name], ptxas = build(name, text, entry, Path(tmp))
            print(json.dumps({"build": name, "entry": entry,
                              "ptxas": ptxas}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        for label, args in probe_sets(torch.device("cuda")).items():
            indptr, indices, rows, targets, pos_map = args
            n, nnz = rows.shape[0], indices.shape[0]
            print(json.dumps({"input": label, **describe(indptr, rows)}),
                  flush=True)
            indexes = {node: build_search_index(indices, node)
                       for node in {p[2] for p in plans.values()} - {None}}
            outs = {name: (torch.empty(n, dtype=torch.bool, device="cuda"),
                           torch.empty(n, dtype=torch.int32, device="cuda"))
                    for name in fns}

            def call(name):
                found, epos = outs[name]
                node = plans[name][2]
                index = indexes[node].data_ptr() if node else None
                err = fns[name](indptr.data_ptr(), indices.data_ptr(), index,
                                rows.data_ptr(), targets.data_ptr(),
                                pos_map.data_ptr() if pos_map is not None
                                else None, nnz, n, found.data_ptr(),
                                epos.data_ptr(), stream)
                if err:
                    raise SystemExit(f"{name}: launch failed, CUDA error "
                                     f"{err}")
                return found, epos

            want = wcoj_intersect_ref(indptr, indices, rows, targets,
                                      pos_map)
            for name in fns:
                got = call(name)
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                print(json.dumps({"check": name, "input": label,
                                  "equal": ok}), flush=True)
                if not ok and name not in ABLATIONS:
                    return 1

            def timed(name):
                for _ in range(2):
                    call(name)
                times = []
                for _ in range(REPS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(QUEUE_CYCLES)
                    a.record()
                    for _ in range(BATCH):
                        call(name)
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b) / BATCH)
                return statistics.median(times)

            timed("base")   # discarded: the card's first timed run reads slow
            order = ["base", *chosen, *reversed(chosen), "base"]
            ms = {name: [] for name in fns}
            for name in order:
                ms[name].append(timed(name))
            print(json.dumps({"input": label, "kernel_ms": ms,
                              "order": order, "probes": n, "nnz": nnz,
                              "card": smi}), flush=True)
        print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
