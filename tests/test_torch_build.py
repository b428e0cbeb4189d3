"""The port's kernel build cache (``repro_torch.kernels._build``): a
library is named by the bytes of its source, of every header the source
includes with quotes (followed recursively) and of the compiler flags, so
an edited header rebuilds every source that includes it.  Nothing here
runs ``nvcc``."""
from repro_torch.kernels import _build


def _tree(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "common").mkdir()
    src = tmp_path / "csrc" / "kern.cu"
    top = tmp_path / "common" / "top.cuh"
    leaf = tmp_path / "common" / "leaf.cuh"
    src.write_text('#include <cuda_runtime.h>\n'
                   '#include "../common/top.cuh"\n'
                   'extern "C" int f() { return g(); }\n')
    top.write_text('#pragma once\n#include "leaf.cuh"\n'
                   'inline int g() { return h() + 1; }\n')
    leaf.write_text('#pragma once\ninline int h() { return 1; }\n')
    return src, top, leaf


def test_library_path_changes_when_only_a_header_changes(tmp_path):
    src, top, _ = _tree(tmp_path)
    before = _build.library_path(src)
    assert _build.library_path(src) == before
    top.write_text(top.read_text().replace("h() + 1", "h() + 2"))
    after = _build.library_path(src)
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith("kern-")


def test_library_path_follows_nested_includes(tmp_path):
    src, top, leaf = _tree(tmp_path)
    assert _build.local_headers(src) == sorted([top.resolve(),
                                               leaf.resolve()])
    before = _build.library_path(src)
    leaf.write_text(leaf.read_text().replace("return 1", "return 3"))
    assert _build.library_path(src) != before


def test_system_includes_and_missing_files_are_left_to_the_compiler(
        tmp_path):
    src = tmp_path / "solo.cu"
    src.write_text('#include <cuda.h>\n#include "not_here.cuh"\n')
    assert _build.local_headers(src) == []
    # a source with no local header hashes as before: source, then flags
    import hashlib
    want = hashlib.sha256(src.read_bytes()
                          + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    assert _build.library_path(src).name == f"solo-{want[:16]}.so"


def test_both_tensor_core_kernels_include_the_shared_header():
    header = (_build.KERNELS_DIR / "_hopper" / "hopper.cuh").resolve()
    sources = {s.stem: s for s in _build.KERNELS_DIR.glob("*/csrc/*.cu")}
    # the header is not a kernel source; K2's backward (its fp32 kernels and
    # its tensor-core route) and K4's backward are sources of their own
    assert len(sources) == 7
    for name in ("flash_attention", "grouped_matmul",
                 "flash_attention_bwd_tc"):
        assert header in _build.local_headers(sources[name])


# ptxas -v as nvcc prints it for one source: two instantiations of a
# kernel (one spilling) and another kernel with a spill of its own
_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attn_rows_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116attn_rows_kernelIfLi64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attn_rows_kernelIfLi128EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116attn_rows_kernelIfLi128EEEvPKT_
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114attn_tc_kernelILi64EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114attn_tc_kernelILi64EEEvv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""


def test_ptxas_report_splits_a_build_log_by_function():
    report = _build.ptxas_functions(_PTXAS_LOG)
    assert len(report) == 3
    rows64 = report["_ZN12_GLOBAL__N_116attn_rows_kernelIfLi64EEEvPKT_"]
    assert rows64[0].startswith("ptxas info    : Compiling entry function")
    assert rows64[-1] == ("ptxas info    : Used 168 registers, used 1 "
                          "barriers, 576 bytes cmem[0]")


def test_spills_are_told_apart_by_function_name():
    n, bad = _build.spills(_PTXAS_LOG, "attn_rows_kernel")
    assert n == 2
    assert bad == ["16 bytes stack frame, 12 bytes spill stores, 12 bytes "
                   "spill loads"]
    # the tc kernel's spill decides nothing about the rows kernels, and the
    # whole log counts all three
    assert _build.spills(_PTXAS_LOG, "attn_tc_kernel")[0] == 1
    assert len(_build.spills(_PTXAS_LOG)[1]) == 2
    assert _build.spills("", "attn_rows_kernel") == (0, [])
