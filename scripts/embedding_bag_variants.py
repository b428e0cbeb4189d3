#!/usr/bin/env python3
"""Time the embedding-bag kernel's ``vec`` route against two variants on
Wide & Deep's ``serve_bulk`` lookup, on one GPU.

    python3 scripts/embedding_bag_variants.py l2_evict_last no_streams

from the repository root, naming the variants to time beside the
committed source (``base``).  Each variant is the source with one design
choice changed:

- ``l2_evict_last``: table rows by ``ld.global.nc`` with the L1
  evict-last hint and an L2 evict-last access policy (``createpolicy`` +
  ``L2::cache_hint``), the kernel's first design;
- ``l1_evict_last``: rows with the L1 evict-last hint alone;
- ``no_streams``: ids by ``__ldg`` and the output by a write-back store,
  not streamed;
- ``chunk16``: 16 slots a chunk (16 row loads in flight a lane, not 8);
- ``field_major``: bags walked field by field down the examples (all
  resident blocks on one field, sharing its hot rows in L1), not in
  their order.

The lookup is the one ``chip_smoke.py`` captures: the reference's seeded
``serve_bulk`` batch (262,144 examples x 40 fields x 8 slots of Zipf(1.2)
ids, offset into the concatenated table) over a random fp32 table of
``CONFIG``'s 107.4M x 32 rows, written as the deep tower writes it: 40
bags a row into the first 1,280 columns of a ``[262144, 1296]`` buffer.
Each build is held against the plain version (1e-4), then timed in turns
after one discarded run (base, variants, variants reversed, base) as the
smoke times K4: batches of 10 calls queued behind a device sleep.
Prints one JSON line per build and timing, and the card's name and power
limit.  Exits non-zero without a CUDA device.
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
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "embedding_bag" /
          "csrc" / "embedding_bag.cu")
BATCH, REPS, QUEUE_CYCLES, TOL = 10, 20, 4_000_000, 1e-4

# load_row_piece's body in the source, and in the cache-hint variants
_ROW_LOAD = "  return __ldg(reinterpret_cast<const uint4*>(p));\n"
_L1_EVICT_LAST = """  uint4 r;
  asm volatile("ld.global.nc.L1::evict_last.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
"""
_L2_EVICT_LAST = """  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  uint4 r;
  asm volatile("ld.global.nc.L1::evict_last.L2::cache_hint.v4.u32 "
               "{%0, %1, %2, %3}, [%4], %5;"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p), "l"(policy));
  return r;
"""

VARIANTS = {
    # the first design: rows under L1 and L2 evict-last hints
    "l2_evict_last": [(_ROW_LOAD, _L2_EVICT_LAST)],
    "l1_evict_last": [(_ROW_LOAD, _L1_EVICT_LAST)],
    "no_streams": [
        ("? __ldcs(bag_ids + s0 + s)", "? __ldg(bag_ids + s0 + s)"),
        ("__stcs(", "__stwb("),
    ],
    "chunk16": [
        ("constexpr int kChunk = 8;", "constexpr int kChunk = 16;"),
    ],
    "field_major": [
        ("const int64_t r = k / G, f = k % G;",
         "const int64_t r = k % (N / G), f = k / (N / G);"),
        ("ids + k * L;", "ids + (r * G + f) * L;"),
    ],
}


def build(name: str, text: str, out_dir: Path):
    from repro_torch.kernels import _build
    src = out_dir / f"{name}.cu"
    lib = out_dir / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).embedding_bag_vec
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i, i64, i, i64, i64, i, p]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in proc.stdout.splitlines() + proc.stderr
             .splitlines() if "registers" in ln or "spill" in ln]
    return fn, ptxas


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("embedding_bag_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chosen = sys.argv[1:]
    unknown = sorted(set(chosen) - set(VARIANTS))
    if not chosen or unknown:
        print(f"embedding_bag_variants: name variants among "
              f"{sorted(VARIANTS)} (unknown: {unknown})", file=sys.stderr)
        return 2
    base = SOURCE.read_text()
    texts = {"base": base}
    for name in chosen:
        text = base
        edits = VARIANTS[name]
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[name] = text
    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for name, text in texts.items():
            fns[name], ptxas = build(name, text, Path(tmp))
            print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)

        cfg = wd.CONFIG
        host = wd.host_batch(cfg, wd.SHAPES["serve_bulk"], seed=0)
        ids = torch.as_tensor(host["sparse_ids"], device="cuda")
        offsets = torch.as_tensor(cfg.field_offsets(), device="cuda")
        gidx = torch.where(ids >= 0, ids + offsets[None, :, None].to(
            ids.dtype), -1).to(torch.int32)
        gidx = gidx.reshape(-1, cfg.max_bag).contiguous()
        table = torch.empty((cfg.total_rows, cfg.embed_dim), device="cuda")
        table.normal_(generator=torch.Generator("cuda").manual_seed(0))
        N, L = gidx.shape
        want = embedding_bag_ref(gidx, table)
        F, D = cfg.n_sparse, cfg.embed_dim
        width = recsys.mlp_input_width(cfg)
        outs = {name: torch.empty((N // F, width), device="cuda")
                for name in fns}
        stream = torch.cuda.current_stream().cuda_stream

        def call(name):
            out = outs[name]
            err = fns[name](gidx.data_ptr(), table.data_ptr(),
                            out.data_ptr(), N, L, cfg.total_rows, D, F,
                            width, 0, stream)
            if err:
                raise SystemExit(f"{name}: launch failed, CUDA error {err}")
            return out

        for name in fns:
            got = call(name)[:, :F * D].reshape(N, D)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
            print(json.dumps({"check": name, "max_abs_err": err, "ok": ok}),
                  flush=True)
            if not ok:
                return 1
        del want

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
        print(json.dumps({"kernel_ms": ms, "order": order,
                          "shape": {"N": N, "L": L, "V": cfg.total_rows,
                                    "D": cfg.embed_dim},
                          "card": smi}), flush=True)
        print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
