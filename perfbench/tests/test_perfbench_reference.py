"""The plain reference against the port on the CPU at generator scale
0.5: every query of the suite."""
import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench import harness
from perfbench.reference.graph import Graph
from perfbench.reference.suite import SUITE
from perfbench.system import build

SF, SEED = 0.5, 5          # at this seed Qr5 and Qr6 match a row
QUERIES = harness.queries()


@pytest.fixture(scope="module")
def both():
    sut = build({"generator_scale": SF}, SEED, "cpu")
    return sut, Graph(sut.raw)


def test_frozen_generator_gives_the_ports_store():
    from repro_torch.graphdb.ldbc import generate_ldbc
    ours = build({"generator_scale": SF}, SEED, "cpu").store
    theirs = generate_ldbc(sf=SF, seed=SEED)
    assert ours.v_count == theirs.v_count
    for t, csr in theirs.out_csr.items():
        assert np.array_equal(ours.out_csr[t].indices, csr.indices)
        assert np.array_equal(ours.in_csr[t].pos, theirs.in_csr[t].pos)


@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_query_equals_the_port(both, name):
    sut, g = both
    q = QUERIES[name]
    tbl, _ = sut.gopt.run(q["text"], q["params"])
    got = {k: np.asarray(v) for k, v in tbl.cols.items()}
    want = SUITE[name](g, q["params"])
    assert want.mismatch(got) is None


def test_topk_with_ties_accepts_any_tied_choice():
    from perfbench.reference.answers import topk
    want = topk(("friend",), "c", [np.array([1, 2, 3, 4])],
                np.array([5, 3, 3, 1]), 2, True)
    assert want.mismatch({"friend": np.array([1, 3]),
                          "c": np.array([5, 3])}) is None
    assert want.mismatch({"friend": np.array([1, 2]),
                          "c": np.array([5, 3])}) is None
    assert want.mismatch({"friend": np.array([1, 4]),
                          "c": np.array([5, 1])}) is not None
    assert want.mismatch({"friend": np.array([1, 2]),
                          "c": np.array([5, 4])}) is not None
