"""The port's copy of the fanout sampler (``repro_torch.graphdb.sampler``)
gives the same arrays as the reference's for the same seed: the
power-law graph's CSR, and the sampled nodes, edges and counts (with the
caps on nodes and edges reached or not)."""
import numpy as np
import pytest

from repro.graphdb import sampler as ref
from repro_torch.graphdb import sampler as smp


@pytest.mark.parametrize("n,deg,seed", [(500, 6, 0), (2_000, 12, 3)])
def test_random_power_law_graph_matches_reference(n, deg, seed):
    a = smp.random_power_law_graph(n, avg_degree=deg, seed=seed)
    b = ref.random_power_law_graph(n, avg_degree=deg, seed=seed)
    assert a.n_nodes == b.n_nodes == n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("fanouts,max_nodes,max_edges", [
    ([10, 5], 4096, 16384),      # roomy
    ([15, 10], 300, 400),        # both caps bind
    ([3], 64, 64),               # one hop
])
def test_sample_fanout_matches_reference(fanouts, max_nodes, max_edges):
    csr = smp.random_power_law_graph(2_000, avg_degree=12, seed=1)
    rcsr = ref.HomoCSR(csr.indptr.copy(), csr.indices.copy(), csr.n_nodes)
    seeds = np.random.default_rng(5).choice(2_000, size=64, replace=False)
    got = smp.sample_fanout(csr, seeds, fanouts,
                            np.random.default_rng(9), max_nodes, max_edges)
    want = ref.sample_fanout(rcsr, seeds, fanouts,
                             np.random.default_rng(9), max_nodes, max_edges)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    nodes, edges, n_n, n_e = got
    assert n_n <= max_nodes and n_e <= max_edges
    assert (nodes[:n_n] >= 0).all() and (nodes[n_n:] == -1).all()
    assert (edges[:, n_e:] == -1).all()
    assert (edges[:, :n_e] < n_n).all()
    np.testing.assert_array_equal(nodes[:len(seeds)], seeds)


def test_from_edges_matches_reference():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    for sym in (True, False):
        a = smp.HomoCSR.from_edges(src, dst, 50, symmetric=sym)
        b = ref.HomoCSR.from_edges(src, dst, 50, symmetric=sym)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
