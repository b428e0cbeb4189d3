"""Fused expand chains on the port's torch operator set (the twin of
``tests/test_fusion.py``, on the CPU): the torch specs plan with the
``fuse_expand_chain`` physical rule, and every chain runs as one eager
program (``torchops.build_fused_chain``) whose membership probes go
through the ``wcoj_intersect`` wrapper.  Fused rows equal the per-hop
loop's and the reference numpy backend's on every Appendix-A query;
fusion is packaging (unfolding recovers the rule-free plan, and the
port's rule plans what the reference's rule plans); one dispatch per
chain, WCOJ tails and edge predicates included; the program cache
plateaus over a pow2 bucket, and an overflow regrows it.  With no volume
cutoff, a volume-bound chain dispatches fused as well."""
import dataclasses

import numpy as np
import pytest

from benchmarks import queries as Q
from repro.core.physical import plan_signature as ref_plan_signature
from repro.core.physical_spec import get_spec as ref_get_spec
from repro.graphdb.jax_backend import fuse_expand_chain as ref_fuse
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical import (ExpandChainNode, plan_operators,
                                       plan_signature, unfuse_chains)
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import FusedChain, TorchOperators

_ALL_SETS = [("ic", Q.QIC, Q.QIC_PARAMS), ("cbo", Q.QC, {}),
             ("rbo", Q.QR, Q.QR_PARAMS), ("typeinf", Q.QT, {})]
_ALL_QUERIES = [(f"{sn}/{name}", text, params.get(name))
                for sn, qs, params in _ALL_SETS
                for name, text in qs.items()]
_IDS = [q[0] for q in _ALL_QUERIES]


@pytest.fixture(scope="module")
def port_gopt(small_ldbc):
    return GOpt(import_store(export_store(small_ldbc)), device="cpu")


@pytest.fixture(scope="module")
def ref_fused_spec():
    """The reference numpy spec (the torch specs' neutral costs) with the
    reference's own fusion rule: the plans the port's rule must equal."""
    return dataclasses.replace(ref_get_spec("numpy"), name="numpy+fuse",
                               physical_rules=(ref_fuse,))


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        np.testing.assert_array_equal(a.cols[k], b.cols[k],
                                      err_msg=f"{msg}/{k}")


def _fused_dispatches(stats) -> int:
    return (stats.kernels or {}).get("dispatch:fused_chain", 0)


def _chains(opt):
    return [n for n in plan_operators(opt.physical)
            if isinstance(n, ExpandChainNode)]


def _ops(gopt):
    return gopt.spec.operators(gopt.store)


# ------------------------------------------------------- fused/unfused parity

@pytest.mark.parametrize("name,text,params", _ALL_QUERIES, ids=_IDS)
def test_fused_parity_all_appendix_queries(port_gopt, gopt_small, name,
                                           text, params):
    """Every Appendix-A query: the measuring run, the fused dispatch and
    the per-hop loop are row-identical to the reference numpy backend, and
    unfolding the chains recovers the plan built without physical
    rules."""
    opt = port_gopt.optimize(text, params)
    raw = port_gopt.optimize(text, params, physical_rules=False)
    assert plan_signature(unfuse_chains(opt.physical)) == \
        plan_signature(raw.physical)
    ref, _ = gopt_small.execute(gopt_small.optimize(text, params),
                                backend="numpy")
    warm, _ = port_gopt.execute(opt)                     # measuring run
    fused, fstats = port_gopt.execute(opt)
    loop, _ = port_gopt.execute(opt, chain_dispatch=False)
    _table_eq(ref, warm, name)
    _table_eq(ref, fused, name)
    _table_eq(ref, loop, name)
    nchains = len(_chains(opt))
    # every chain inside the fusable envelope dispatches fused once warm
    # (no volume cutoff); the ic point queries must
    assert _fused_dispatches(fstats) <= nchains, fstats.kernels
    if name in ("ic/ic1", "ic/ic3", "ic/ic11", "ic/ic12"):
        assert nchains and _fused_dispatches(fstats) == nchains, \
            fstats.kernels


@pytest.mark.parametrize("name,text,params", _ALL_QUERIES, ids=_IDS)
def test_port_rule_plans_what_the_reference_rule_plans(
        port_gopt, gopt_small, ref_fused_spec, name, text, params):
    got = port_gopt.optimize(text, params)
    want = gopt_small.optimize(text, params, backend=ref_fused_spec)
    assert got.invalid == want.invalid
    if not want.invalid:
        assert plan_signature(got.physical) == \
            ref_plan_signature(want.physical)


# ------------------------------------------------ single-dispatch 3-hop chain

THREE_HOP = ("MATCH (a:PERSON)-[:KNOWS*3]-(z:PERSON) "
             "WHERE a.id = $pid RETURN count(z) AS c")


def test_multi_hop_chain_single_dispatch(port_gopt, gopt_small):
    """A >=3-hop chain (ic12: friend -> comment -> post -> tag -> tagclass)
    runs as exactly ONE dispatch — no per-hop expands — row-identical to
    the reference numpy backend."""
    opt = port_gopt.optimize(Q.QIC["ic12"], Q.QIC_PARAMS["ic12"])
    chains = _chains(opt)
    assert len(chains) == 1 and len(chains[0].steps) >= 3
    ref, _ = gopt_small.execute(gopt_small.optimize(
        Q.QIC["ic12"], Q.QIC_PARAMS["ic12"]), backend="numpy")
    port_gopt.execute(opt)                               # measuring run
    tbl, stats = port_gopt.execute(opt)
    _table_eq(ref, tbl)
    assert _fused_dispatches(stats) == 1, stats.kernels
    assert (stats.kernels or {}).get("dispatch:expand", 0) == 0


def test_volume_bound_chain_dispatches_fused(port_gopt, gopt_small):
    """The reference keeps chains past its interpret-mode volume cutoff on
    the loop; the port has no cutoff, so the 3-hop KNOWS chain dispatches
    fused once warm — row-identical to numpy."""
    opt = port_gopt.optimize(THREE_HOP, {"pid": 5}, cbo=False)
    ref, _ = gopt_small.execute(gopt_small.optimize(
        THREE_HOP, {"pid": 5}, cbo=False), backend="numpy")
    port_gopt.execute(opt)                               # measuring run
    tbl, stats = port_gopt.execute(opt)
    _table_eq(ref, tbl)
    assert _fused_dispatches(stats) == 1, stats.kernels


# ------------------------------------------------------------- wcoj tail step

TRIANGLE = ("Match (a:PERSON)-[:KNOWS]->(b:PERSON)-[:KNOWS]->(c:PERSON), "
            "(a)-[:KNOWS]->(c) Return count(a) AS t")


def test_chain_with_wcoj_tail_single_dispatch(port_gopt, gopt_small):
    """A chain ending in an expand-and-intersect folds the membership
    probes into the fused program: one dispatch, no separate intersect,
    each probe one call of the ``wcoj_intersect`` wrapper."""
    opt = port_gopt.optimize(TRIANGLE, cbo=False)
    chains = _chains(opt)
    assert chains and chains[-1].steps[-1].intersect_edges
    ref, _ = gopt_small.execute(gopt_small.optimize(TRIANGLE, cbo=False),
                                backend="numpy")
    port_gopt.execute(opt)                               # measuring run
    tbl, stats = port_gopt.execute(opt)
    _table_eq(ref, tbl)
    assert _fused_dispatches(stats) == 1, stats.kernels
    assert (stats.kernels or {}).get("dispatch:intersect", 0) == 0
    assert stats.kernels.get("probe:fused_chain", 0) == \
        len(chains[-1].steps[-1].intersect_edges)
    loop, _ = port_gopt.execute(opt, chain_dispatch=False)
    _table_eq(ref, loop)


# --------------------------------------------------- folded edge predicates

EDGE_PRED_Q = ("Match (a:PERSON)-[k:KNOWS]->(b:PERSON)-[k2:KNOWS]->"
               "(c:PERSON) Where k2.creationDate >= 3 and b.id <> 7 "
               "Return count(a) AS n")


def test_chain_folds_edge_property_predicates(port_gopt, gopt_small):
    opt = port_gopt.optimize(EDGE_PRED_Q, cbo=False)
    assert _chains(opt)
    ref, _ = gopt_small.execute(gopt_small.optimize(EDGE_PRED_Q, cbo=False),
                                backend="numpy")
    port_gopt.execute(opt)                               # measuring run
    tbl, stats = port_gopt.execute(opt)
    _table_eq(ref, tbl)
    assert _fused_dispatches(stats) == 1, stats.kernels


# ------------------------------------------------- program-cache bounding

JITTER_Q = ("MATCH (p:PERSON)-[:KNOWS]->(f:PERSON)-[:KNOWS]->(g:PERSON) "
            "WHERE p.id IN $S RETURN count(p) AS c")


def test_bucketing_bounds_program_cache(port_gopt, gopt_small):
    """Jittered input sizes inside one pow2 bucket reuse one program: the
    compile counter plateaus while the dispatch counter keeps climbing."""
    ops = _ops(port_gopt)
    peek = {"S": list(range(15))}
    pq = port_gopt.prepare(JITTER_Q, peek)
    assert _chains(pq)
    ref_pq = gopt_small.prepare(JITTER_Q, peek, backend="numpy")
    big = {"S": list(range(15))}
    t, _ = pq.execute(big)
    _table_eq(ref_pq.execute(big)[0], t)
    mark = ops.kernel_stats.mark()
    sizes = (12, 13, 14, 15)
    for k in sizes:
        b = {"S": list(range(k))}
        t, _ = pq.execute(b)
        _table_eq(ref_pq.execute(b)[0], t, f"S={k}")
    compiles = ops.kernel_stats.count("compile", "fused_chain", since=mark)
    dispatches = ops.kernel_stats.count("dispatch", "fused_chain",
                                        since=mark)
    assert dispatches == len(sizes)
    assert compiles <= 1, (compiles, dispatches)


def test_capacity_overflow_regrows_and_stays_correct(port_gopt, gopt_small):
    """An execution whose totals overflow the learned capacities falls
    back to the loop (row-identical) and regrows them; the next execution
    at that size dispatches fused again."""
    peek = {"S": list(range(15))}
    pq = port_gopt.prepare(JITTER_Q, peek)
    ref_pq = gopt_small.prepare(JITTER_Q, peek, backend="numpy")
    small, big = {"S": [1]}, {"S": list(range(60))}
    t, _ = pq.execute(small)                      # measuring run, tiny caps
    _table_eq(ref_pq.execute(small)[0], t)
    t, _ = pq.execute(small)                      # fused at tiny caps
    _table_eq(ref_pq.execute(small)[0], t)
    t, stats = pq.execute(big)                    # overflow -> loop, regrow
    _table_eq(ref_pq.execute(big)[0], t)
    assert stats.fallbacks.get("chain_capacity", 0) == 1, stats.fallbacks
    ops = _ops(port_gopt)
    mark = ops.kernel_stats.mark()
    t, stats = pq.execute(big)                    # fused at regrown caps
    _table_eq(ref_pq.execute(big)[0], t)
    assert ops.kernel_stats.count("dispatch", "fused_chain", since=mark) == 1


def test_empty_in_set_is_a_static_variant(port_gopt, gopt_small):
    peek = {"S": list(range(15))}
    pq = port_gopt.prepare(JITTER_Q, peek)
    ref_pq = gopt_small.prepare(JITTER_Q, peek, backend="numpy")
    pq.execute(peek)                              # measuring run
    for b in ({"S": []}, {"S": [3]}, {"S": []}):
        t, _ = pq.execute(b)
        _table_eq(ref_pq.execute(b)[0], t, repr(b))


def test_blowup_guard_raises_inside_the_fused_program(port_gopt):
    opt = port_gopt.optimize(THREE_HOP, {"pid": 5}, cbo=False)
    port_gopt.execute(opt)                               # measuring run
    _, stats = port_gopt.execute(opt)
    assert _fused_dispatches(stats) == 1
    with pytest.raises(RuntimeError, match="intermediate blow-up"):
        port_gopt.execute(opt, max_rows=10)


# ------------------------------------------------------------ chain handles

def test_chain_spec_memoized_on_plan_node(port_gopt):
    """The ChainSpec is built once per plan node and reused across engines
    (prepared-query serving): repeated executions share one handle."""
    opt = port_gopt.optimize(Q.QIC["ic1"], {"pid": 5})
    node = _chains(opt)[0]
    port_gopt.execute(opt, params={"pid": 5})
    key, spec = node.__dict__["_chain_spec"]
    assert spec is not None
    port_gopt.execute(opt, params={"pid": 5})
    assert node.__dict__["_chain_spec"][1] is spec
    ops = _ops(port_gopt)
    prog = ops.chain_program(spec)
    assert isinstance(prog, FusedChain) and prog.ready()
    assert ops.chain_program(spec) is prog


def test_pinned_chain_survives_eviction(port_gopt):
    opt = port_gopt.optimize(Q.QIC["ic1"], {"pid": 5})
    port_gopt.execute(opt, params={"pid": 5})
    spec = _chains(opt)[0].__dict__["_chain_spec"][1]
    ops = TorchOperators(port_gopt.store, device="cpu")
    assert not ops.pin_chain(spec)                # nothing to pin yet
    prog = ops.chain_program(spec)
    assert ops.pin_chain(spec)
    for i in range(80):                           # flood the 64-handle LRU
        ops.chain_program(dataclasses.replace(spec, source=f"x{i}"))
    assert len(ops._chains) == 64
    assert ops.chain_program(spec) is prog and prog.pinned
    assert ops.pin_chain(spec, False) and not prog.pinned
