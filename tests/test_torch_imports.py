"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports jax, the reference package or the benchmarks;
its entry points refuse to run on cuda without a card instead of falling
back to the CPU; and the smoke script's query copy matches the benchmark
set."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import queries as Q

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"^(jax|jaxlib|repro|benchmarks)(\.|$)")
_MODULE_PATH = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)*$")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and _MODULE_PATH.match(node.value)):
            # module paths handed to importlib (lazy backend registry)
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_reference_or_benchmarks(path):
    bad = [(ln, mod) for ln, mod in _imports(path) if _FORBIDDEN.match(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"torch_backend.py", "engine.py", "gopt.py", "ops.py",
            "transformer.py", "chip_smoke.py", "recsys.py", "wide_deep.py",
            "base.py", "torchops.py", "gremlin.py", "partition.py",
            "sharded_backend.py", "irreps.py", "gat.py", "equiformer_v2.py",
            "sampler.py", "optimizer.py", "gnn_common.py", "data.py",
            "checkpoint.py", "loop.py", "step.py", "train.py",
            "host_staging.py"} <= names
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    assert {p.parent.name for p in PORT_FILES if p.parent.parent == kernels
            and p.name == "ops.py"} == {"wcoj_intersect", "flash_attention",
                                        "grouped_matmul", "embedding_bag"}


def test_gopt_without_device_raises_without_a_card(small_ldbc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.engine import Engine
    from repro_torch.graphdb.storage import export_store, import_store
    store = import_store(export_store(small_ldbc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GOpt(store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GOpt(store, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(store)
    # the GNN family: its bundles' concrete state and every init_params
    from repro_torch.configs import gat_cora
    from repro_torch.models.gnn import equiformer_v2, gat, nequip, schnet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gat_cora.bundle(smoke=True).make_concrete("molecule")
    gen = torch.Generator()
    for mod, cfg in ((gat, gat.GATConfig()), (schnet, schnet.SchNetConfig()),
                     (nequip, nequip.NequIPConfig()),
                     (equiformer_v2, equiformer_v2.EquiformerV2Config())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.init_params(cfg, gen)


def test_smoke_query_copy_matches_the_benchmark_set():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = ([(k, v, None) for k, v in Q.QT.items()]
            + [(k, v, Q.QR_PARAMS.get(k)) for k, v in Q.QR.items()]
            + [(k, v, None) for k, v in Q.QC.items()]
            + [(k, v, Q.QIC_PARAMS[k]) for k, v in Q.QIC.items()])
    assert chip_smoke.QUERIES == want


def test_smoke_fails_alone_and_without_a_card(tmp_path):
    """Copied into an otherwise empty directory (and, here, with no card)
    the smoke script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
