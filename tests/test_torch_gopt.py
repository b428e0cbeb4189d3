"""The port's whole slice on the CPU — store -> GOpt (Statistics + GLogue)
-> parse -> type inference -> RBO -> CBO -> Engine on the torch operator
set -> delivery — held against the reference ``GOpt`` on the same store:
GLogue frequencies equal, plans equal the reference numpy-spec plans (with
fused chains unfolded), and results are row-identical to the reference
numpy backend for every parity query (and to the reference jax backend for
a few)."""
import numpy as np
import pytest

from benchmarks import queries as Q
from repro.core.physical import plan_signature as ref_plan_signature
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical import plan_signature, unfuse_chains
from repro_torch.core.physical_spec import TransferStats
from repro_torch.graphdb.storage import export_store, import_store

PARITY_QUERIES = (
    [("typeinf/" + k, v, None) for k, v in Q.QT.items()]
    + [("rbo/" + k, v, Q.QR_PARAMS.get(k)) for k, v in Q.QR.items()]
    + [("cbo/" + k, v, None) for k, v in Q.QC.items()]
    + [("ldbc/" + k, v, Q.QIC_PARAMS[k]) for k, v in Q.QIC.items()]
)
IDS = [q[0] for q in PARITY_QUERIES]
JAX_QUERIES = [q for q in PARITY_QUERIES
               if q[0] in ("cbo/Qc1a", "rbo/Qr5", "ldbc/ic1")]


def _table_eq(a, b):
    assert a.nrows == b.nrows
    assert set(a.cols) == set(b.cols)
    for k in a.cols:
        assert np.asarray(a.cols[k]).dtype == np.asarray(b.cols[k]).dtype, k
        np.testing.assert_array_equal(a.cols[k], b.cols[k], err_msg=k)


@pytest.fixture(scope="module")
def port_gopt(small_ldbc):
    return GOpt(import_store(export_store(small_ldbc)), device="cpu")


def test_port_gopt_pins_the_cpu_spec(port_gopt):
    assert port_gopt.spec.name == "torch[cpu]"
    assert port_gopt.glogue.spec is port_gopt.spec
    assert set(port_gopt.store._physical_ops_cache) == {"torch[cpu]"}


def test_glogue_frequencies_equal_reference(port_gopt, gopt_small):
    assert port_gopt.glogue.freq == gopt_small.glogue.freq


@pytest.mark.parametrize("name,text,params", PARITY_QUERIES, ids=IDS)
def test_plan_equals_reference_numpy_plan(port_gopt, gopt_small, name, text,
                                          params):
    """The port's plans, with their fused chains unfolded, are the
    reference numpy-spec plans (both specs cost alike; the torch specs add
    the ``fuse_expand_chain`` physical rule)."""
    ref = gopt_small.optimize(text, params, backend="numpy")
    got = port_gopt.optimize(text, params)
    assert got.invalid == ref.invalid
    if not ref.invalid:
        assert plan_signature(unfuse_chains(got.physical)) == \
            ref_plan_signature(ref.physical)


@pytest.mark.parametrize("name,text,params", PARITY_QUERIES, ids=IDS)
def test_results_equal_reference_numpy(port_gopt, gopt_small, name, text,
                                       params):
    ref, _ = gopt_small.execute(gopt_small.optimize(text, params),
                                backend="numpy")
    got, stats = port_gopt.execute(port_gopt.optimize(text, params))
    _table_eq(got, ref)
    assert TransferStats.mid_plan_d2h(stats.transfers) == 0


@pytest.mark.parametrize("name,text,params", JAX_QUERIES,
                         ids=[q[0] for q in JAX_QUERIES])
def test_results_equal_reference_jax(port_gopt, gopt_small, name, text,
                                     params):
    ref, _ = gopt_small.execute(gopt_small.optimize(text, params),
                                backend="jax")
    got, _ = port_gopt.execute(port_gopt.optimize(text, params))
    _table_eq(got, ref)


def test_two_hop_query_stays_on_the_device(port_gopt):
    tbl, stats = port_gopt.run(Q.QIC["ic1"], Q.QIC_PARAMS["ic1"])
    assert tbl.nrows > 0
    assert TransferStats.mid_plan_d2h(stats.transfers) == 0
    assert any(k.startswith("deliver:") for k in stats.transfers)


def test_cycle_query_goes_through_the_probe(port_gopt):
    """The closing edge is a WCOJ probe: an ``intersect`` dispatch on the
    per-hop loop, a probe inside the program once the chain is fused."""
    opt = port_gopt.optimize(Q.QC["Qc1a"])
    assert "x2" in plan_signature(opt.physical)
    _, stats = port_gopt.execute(opt, chain_dispatch=False)
    assert stats.kernels.get("dispatch:intersect", 0) > 0
    port_gopt.execute(opt)                  # measures the chain, if new
    _, stats = port_gopt.execute(opt)
    assert stats.kernels.get("dispatch:fused_chain", 0) == 1
    assert stats.kernels.get("probe:fused_chain", 0) > 0


def test_prepared_batch_matches_single_runs(port_gopt):
    pq = port_gopt.prepare(Q.QIC["ic3"])
    binds = [{"pid": p} for p in (3, 5, 9)]
    batch = pq.execute_many(binds)
    for (tb, _), b in zip(batch, binds):
        single, _ = pq.execute(b)
        _table_eq(tb, single)


EDGE_QUERIES = [
    ("string_literal", "MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
     "WHERE p.id = $pid RETURN f, 'x' AS tag ORDER BY f LIMIT 3",
     {"pid": 5}),
    ("string_predicate", "MATCH (p:PERSON) WHERE p.firstName = 'Maria' "
     "RETURN count(p) AS c", None),
    ("edge_prop_distinct", "MATCH (p:PERSON)-[k:KNOWS]->(f:PERSON) "
     "WHERE k.creationDate > 1300000000 RETURN DISTINCT f ORDER BY f "
     "LIMIT 5", None),
    ("aggregates", "MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
     "WHERE p.id IN [1,2,3] AND NOT f.id = 4 RETURN p, sum(f.id) AS s, "
     "avg(f.id) AS a, min(f.id) AS lo, max(f.id) AS hi ORDER BY p", None),
    ("empty_count", "MATCH (p:PERSON) WHERE p.id = 999999 "
     "RETURN count(p) AS c", None),
    ("empty_group", "MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
     "WHERE p.id = 999999 RETURN p, count(f) AS c", None),
]


@pytest.mark.parametrize("name,text,params", EDGE_QUERIES,
                         ids=[q[0] for q in EDGE_QUERIES])
def test_tail_edge_cases_equal_reference_numpy(port_gopt, gopt_small, name,
                                               text, params):
    """String literals (host-only columns), string-encoded predicates,
    edge properties, DISTINCT, every aggregate, and the empty-input
    fix-ups of the relational tail."""
    ref, _ = gopt_small.run(text, params, backend="numpy")
    got, _ = port_gopt.run(text, params)
    _table_eq(got, ref)
