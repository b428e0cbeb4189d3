import os
import sys

# keep the default 1-device CPU view (the dry-run sets 512 in its own
# process); tests must never import repro.launch.dryrun
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so tests can import the benchmark query sets (benchmarks.queries)
sys.path.insert(1, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.graphdb.ldbc import generate_ldbc, generate_motivating  # noqa: E402


@pytest.fixture(scope="session")
def tiny_store():
    return generate_motivating(n_person=50, n_product=20, n_place=8)


@pytest.fixture(scope="session")
def small_ldbc():
    return generate_ldbc(sf=0.15)


@pytest.fixture(scope="session")
def gopt_small(small_ldbc):
    from repro.core.gopt import GOpt
    return GOpt(small_ldbc)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself without "
        "one (the PyTorch port's kernels have no CPU mode)")
