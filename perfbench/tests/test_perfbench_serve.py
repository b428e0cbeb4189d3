"""The port's ``QueryServer`` against the benchmark's reference on the CPU
at generator scale 0.5: each of the four ``$pid`` reads answered for 16
seeded pids in one wave (duplicates included) equals
``reference/suite.py`` run per pid."""
import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench import harness
from perfbench.reference.graph import Graph
from perfbench.reference.suite import SUITE
from perfbench.system import build

SF, SEED = 0.5, 5
READS = ["ic1", "ic3", "ic11", "ic12"]


@pytest.fixture(scope="module")
def sut():
    return build({"generator_scale": SF}, SEED, "cpu")


@pytest.fixture(scope="module")
def graph(sut):
    return Graph(sut.raw)


def _pids(sut) -> list[int]:
    """Eight seeded pids, seven of them again, and the busiest person of
    the graph: 16 reads, 9 bindings."""
    rng = np.random.default_rng(SEED)
    first = rng.integers(sut.raw.counts["PERSON"], size=8).tolist()
    again = rng.choice(first, size=7).tolist()
    _, dst = sut.raw.edges[("PERSON", "KNOWS", "PERSON")]
    return first + again + [int(np.bincount(dst).argmax())]


@pytest.mark.parametrize("name", READS)
def test_one_wave_of_sixteen_pids_equals_the_reference(sut, graph, name):
    from repro_torch.graphdb.serve import QueryServer
    q = harness.queries()[name]
    pids = _pids(sut)
    assert len(set(pids)) < len(pids)          # duplicates in the wave
    srv = QueryServer(sut.gopt, max_rows=100_000_000)
    try:
        pq = sut.gopt.prepare(q["text"], q["params"])
        reqs = [srv.submit(pq, {"pid": p}) for p in pids]
        srv.drain()
    finally:
        srv.close()
    assert srv.stats.waves == 1 and srv.stats.wave_sizes == [len(pids)]
    assert srv.stats.deduped == len(pids) - len(set(pids))
    for r, pid in zip(reqs, pids):
        assert r.status == "done", r.error
        got = {k: np.asarray(v) for k, v in r.table.cols.items()}
        want = SUITE[name](graph, {"pid": pid})
        assert want.mismatch(got) is None, (pid, want.mismatch(got))
