#!/usr/bin/env python3
"""Time K2's ``rows`` route (fp32, TF32 off) built from one or more copies
of ``flash_attention.cu``, on the shapes the training and serving paths
give it, on one GPU.

    python3 scripts/attention_rows_compare.py [SOURCE ...]

from the repository root.  With no argument it times the committed source;
name another copy (an older commit unpacked by ``git archive``, its
relative include of ``_hopper/hopper.cuh`` resolved in that copy) to time
the two in turns.  Each source is built with nvcc into a temporary
directory (ptxas' report of its ``attn_rows_kernel`` instantiations
printed), and on every shape held against the plain version (output 2e-3,
log-sum-exp 1e-4) and against itself over two calls (bit-equal).  Then
every source is timed in turns, in order and then reversed (parent,
change, change, parent for two), each run a batch of 10 calls queued
behind a device sleep, the median of 20, beside SDPA with ``is_causal`` on
the same inputs.  Shapes:

- ``lm100m_layer0``: B 8, 1,024 tokens, 12 heads, head_dim 64;
- ``lm-moe_layer0``: B 16, 1,024 tokens, 8 heads, head_dim 32;
- ``prefill_fp32``: one 1,992-token prompt of OLMoE-1B-7B (16 heads,
  head_dim 128) in one slot of a 4,096-row cache (SDPA over the filled
  rows).

Prints one JSON line per build, check and timing, and the card's name and
power limit.  Exits non-zero without a CUDA device.
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
sys.path.insert(0, str(ROOT / "src"))
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" /
          "csrc" / "flash_attention.cu")
BATCH, REPS, QUEUE_CYCLES = 10, 20, 4_000_000
TOL, LSE_TOL = 2e-3, 1e-4
FP32_OPS_PER_S = 67e12     # H100 SXM, fp32 outside the tensor cores
NO_WINDOW = 1 << 30
# name: (B, Sq, Skv, heads, head_dim, kv_len)
SHAPES = {"lm100m_layer0": (8, 1024, 1024, 12, 64, 1024),
          "lm-moe_layer0": (16, 1024, 1024, 8, 32, 1024),
          "prefill_fp32": (1, 1992, 4096, 16, 128, 1992)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(source: Path, out_dir: Path):
    """The library built from ``source`` and ptxas' rows-kernel lines."""
    from repro_torch.kernels import _build
    lib = out_dir / f"rows_{len(list(out_dir.iterdir()))}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(source)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{proc.stdout}")
    report = {f: ls for f, ls in _build.ptxas_functions(proc.stdout).items()
              if "attn_rows_kernel" in f}
    fn = ctypes.CDLL(str(lib)).flash_attention_rows
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    fn.restype = ctypes.c_int
    return fn, report


def queued_ms(fn) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return statistics.median(times)


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    if not torch.cuda.is_available():
        print("attention_rows_compare: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    sources = [Path(a).resolve() for a in sys.argv[1:]] or [SOURCE]
    with tempfile.TemporaryDirectory() as tmp:
        fns = {}
        for src in sources:
            fns[str(src)], report = build(src, Path(tmp))
            emit({"build": str(src), "ptxas": report})
        g = torch.Generator(device="cuda").manual_seed(0)
        ok = True
        for shape, (B, Sq, Skv, H, hd, n) in SHAPES.items():
            q = torch.randn(B, Sq, H, 1, hd, generator=g, device="cuda")
            k = torch.randn(B, Skv, H, hd, generator=g, device="cuda")
            v = torch.randn(B, Skv, H, hd, generator=g, device="cuda")
            starts = torch.zeros(B, dtype=torch.int32, device="cuda")
            lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)
            lse = torch.empty(B, H, Sq, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         starts.data_ptr(), lens.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), B, Sq, Skv, H, 1, hd, NO_WINDOW,
                         0.0, 0, stream)
                if err:
                    raise SystemExit(f"rows launch failed: CUDA error {err}")

            want, want_lse = flash_attention_ref(q, k, v, starts, lens,
                                                 return_lse=True)
            for src, fn in fns.items():
                call(fn)
                first = (out.clone(), lse.clone())
                call(fn)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                lse_err = float((lse - want_lse).abs().max())
                same = (torch.equal(first[0], out)
                        and torch.equal(first[1], lse))
                good = (bool(torch.allclose(out, want, rtol=TOL, atol=TOL))
                        and bool(torch.allclose(lse, want_lse, rtol=LSE_TOL,
                                                atol=LSE_TOL)) and same)
                ok &= good
                emit({"check": shape, "source": src, "max_abs_err": err,
                      "lse_max_abs_err": lse_err, "bit_equal": same,
                      "ok": good})
            del want, want_lse
            pairs = B * H * n * (n + 1) // 2
            heads = (q.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, hd),
                     k[:, :n].permute(0, 2, 1, 3),
                     v[:, :n].permute(0, 2, 1, 3))
            runs = {src: [] for src in fns}
            for src in list(fns) + list(fns)[::-1]:
                runs[src].append(queued_ms(lambda: call(fns[src])))
            sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
                *heads, is_causal=True))
            bound = 4 * hd * pairs / FP32_OPS_PER_S * 1e3
            for src, ms in runs.items():
                emit({"time": shape, "source": src, "ms": ms,
                      "ms_median": statistics.median(ms),
                      "bound_ms": bound, "bound_by": "operations",
                      "pct_of_bound": 100 * bound / statistics.median(ms),
                      "sdpa_is_causal_ms": sdpa, "pairs": pairs})
            del q, k, v, out, lse, heads
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
