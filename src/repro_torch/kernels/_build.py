"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/*.cu`` exposes plain C functions (no PyTorch headers), so one
``nvcc`` call per source takes seconds.  Libraries land in ``_build/``
beside this file, named by a hash of the source, the headers it includes
(``#include "..."``, followed recursively) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  Building happens at
first use (or up front through ``build``/``build_all``), never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
# sm_90a (not sm_90): Hopper's arch-specific features (wgmma, setmaxnreg)
# exist only for that target; -Xptxas -v reports registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` (the
    toolkit's default prefix when unset)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list[Path]:
    """The files ``source`` includes with quotes, and those they include,
    resolved against the including file's directory as nvcc does; sorted.
    An include that names no file there is left to the compiler."""
    seen: set[Path] = set()
    todo = [source]
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.is_file() and dep not in seen:
                seen.add(dep)
                todo.append(dep)
    return sorted(seen)


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> dict:
    """Compile ``source`` unless its library exists.  Returns ``{"path",
    "seconds", "log", "cached"}`` (``log`` holds ptxas' register and spill
    report); raises ``RuntimeError`` with the compiler output on failure."""
    out = library_path(source)
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temporary name, renamed into place when complete, so a
    # concurrent builder never loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {source.name}: nvcc "
                           f"exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": proc.stdout, "cached": False}


def build_all() -> dict[Path, dict]:
    """``build`` every kernel source of the port (``*/csrc/*.cu``), one
    ``nvcc`` process each, all started together.  Returns ``{source:
    build(source)}``; the first failure raises once every build has
    ended."""
    sources = sorted(KERNELS_DIR.glob("*/csrc/*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {src: pool.submit(build, src) for src in sources}
    return {src: fut.result() for src, fut in futures.items()}


_PTXAS_FUNCTION = re.compile(
    r"(?:Compiling entry function '([^']+)'|Function properties for (\S+))")


def ptxas_functions(log: str) -> dict[str, list[str]]:
    """ptxas' ``-v`` report in a build log, by function: ``{mangled name:
    its lines}``, each line from the one that names the function up to the
    next that names another (its registers, stack frame and spills)."""
    report: dict[str, list[str]] = {}
    lines = None
    for ln in log.splitlines():
        m = _PTXAS_FUNCTION.search(ln)
        if m:
            lines = report.setdefault(m.group(1) or m.group(2), [])
        if lines is not None:
            lines.append(ln.strip())
    return report


def spills(log: str, name: str = "") -> tuple[int, list[str]]:
    """``(functions, spill lines)``: how many functions of a build log whose
    mangled name holds ``name`` ptxas reported, and their lines that report
    a spill store or load of more than 0 bytes."""
    found = {f: ls for f, ls in ptxas_functions(log).items() if name in f}
    bad = [ln for ls in found.values() for ln in ls if "spill" in ln
           and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    return len(found), bad


_LOADED: dict[Path, ctypes.CDLL] = {}


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it on first use."""
    lib = _LOADED.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build(source)
        lib = _LOADED[source] = ctypes.CDLL(str(path))
    return lib
