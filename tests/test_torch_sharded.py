"""The port's sharded backend (``repro_torch.graphdb.sharded_backend``), the
twin of ``tests/test_sharded.py``.

In process, in a one-rank gloo group on the CPU (the backend creates it):
operator conformance with the collectives recorded, Appendix-A and tail
rows equal to the port's and the reference's ``numpy`` specs, rows and the
exchange ledger equal to the reference's sharded backend
(``GOpt(..., backend="sharded", devices=1)``, pinned because another
module may fake an 8-device mesh in the same process) query by query —
keys, calls and elements —, the blow-up guard, the ``devices=`` /
``device=`` spec pinning, the cost model's exchange term, the PROFILE
exchange section, the streamed generator on the sharded spec, the
rank-local K1 probe of a partition summing to the probe of the whole CSR,
and ``PhysicalSpec.release``.

In spawned gloo worlds of 2 and 4 ranks (``tests/_sharded_world.py``, one
spawn a world, a deadline that kills a hung world): the same queries give
rows identical (value and order) to the port's ``numpy`` spec on every
rank and to the reference's ``numpy`` spec on the same store built in the
parent, with no mid-plan device->host copy; the ledger is the one-rank
ledger plus one ``all_gather:expand_replicate`` per reduce-scattered
expand column and the tail's gathers; a rank holds only its blocks (no
whole-CSR twin, block bytes within 1/S of the CSR's plus the block's
padding); a world of 4 pinned to 2 shards answers on ranks 0-1, refuses
on 2-3, and its release destroys the subgroup only; and, at S=2, the
delta store's overlay parity and snapshot isolation, held to the
reference too (the twins of ``tests/test_delta.py``'s sharded cases; the
S=1 ones are in ``test_torch_delta.py``).  Tolerance: exact equality
everywhere."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _sharded_world as W
from benchmarks import queries as Q
from repro.core.gopt import GOpt as RefGOpt
from repro.graphdb.ldbc import generate_ldbc as ref_generate_ldbc
from repro_torch.core.cardinality import CardEstimator
from repro_torch.core.cbo import GraphOptimizer
from repro_torch.core.gopt import GOpt
from repro_torch.core.physical_spec import (TransferStats, _conf_csr,
                                            get_spec, validate_operator_set)
from repro_torch.graphdb.ldbc import (generate_ldbc, generate_ldbc_streamed,
                                      generate_motivating)
from repro_torch.graphdb.partition import partition_csr
from repro_torch.graphdb.sharded_backend import (ShardedOperators,
                                                 block_probe, sharded_spec,
                                                 upload_block)
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import torch_spec
from repro_torch.kernels.wcoj_intersect.ops import build_search_index
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref

PARITY = W.parity_queries()
NAMES = [p[0] for p in PARITY]
TAIL_NAMES = [q[0] for q in W.TAIL_QUERIES]
TAIL_GATHERS = {"join", "combine_keys", "order", "distinct", "group_keys"}


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, msg
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        x, y = np.asarray(a.cols[k]), np.asarray(b.cols[k])
        assert x.dtype == y.dtype, f"{msg}/{k}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}/{k}")


def _cols_eq(a: dict, b: dict, msg=""):
    assert set(a) == set(b), msg
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{msg}/{k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}/{k}")


@pytest.fixture(scope="module")
def port_small(small_ldbc):
    return import_store(export_store(small_ldbc))


@pytest.fixture(scope="module")
def sharded_gopt(port_small):
    return GOpt(port_small, backend="sharded", devices=1, device="cpu")


def _fresh_ops(store):
    """A NEW operator set (``spec.operators`` memoizes per store)."""
    return ShardedOperators(store, devices=1, device="cpu")


@pytest.fixture(scope="module")
def ref_sharded(small_ldbc):
    # one device: another module may fake an 8-device mesh in this process
    return RefGOpt(small_ldbc, backend="sharded", devices=1)


def _ref_numpy(ref_gopt, text, params):
    """The reference's ``numpy`` spec on the plan the reference optimises
    for its sharded spec (the port's sharded plans are those plans)."""
    opt = ref_gopt.optimize(text, params, backend="sharded")
    return ref_gopt.execute(opt, backend="numpy")[0]


# ------------------------------------------------------------- conformance

def test_sharded_conformance(port_small):
    ops = _fresh_ops(port_small)
    assert ops.n_shards == 1 and ops.name == "sharded"
    assert not ops.supports_chains
    validate_operator_set(ops, conformance=True)
    # the pattern collectives ran and were recorded at S=1
    assert ops.exchange_stats.count(kind="psum") > 0
    assert ops.exchange_stats.count(kind="psum_scatter") > 0
    assert ops.exchange_stats.count(kind="all_gather") == 0


# ------------------------------------------------- end-to-end query parity

@pytest.mark.parametrize("name,text,params", PARITY, ids=NAMES)
def test_sharded_appendix_parity(sharded_gopt, gopt_small, name, text,
                                 params):
    opt = sharded_gopt.optimize(text, params)
    ref, _ = sharded_gopt.execute(opt, backend="numpy")
    tbl, stats = sharded_gopt.execute(opt)
    _table_eq(tbl, ref, name)
    _table_eq(tbl, _ref_numpy(gopt_small, text, params), f"{name} (ref)")
    # the distributed residency contract: collectives recorded, zero
    # mid-plan host transfers, one host gather at delivery
    assert stats.exchanges, "no collective exchanges recorded"
    assert TransferStats.mid_plan_d2h(stats.transfers) == 0, stats.transfers
    if tbl.nrows:
        assert stats.transfers.get("deliver:d2h", {}).get("calls", 0) > 0


@pytest.mark.parametrize("name,text,params", W.TAIL_QUERIES, ids=TAIL_NAMES)
def test_sharded_tail_equals_numpy(sharded_gopt, gopt_small, name, text,
                                   params):
    """Every aggregate, DISTINCT and a two-key ORDER BY at one shard, equal
    to the port's and the reference's ``numpy`` specs."""
    opt = sharded_gopt.optimize(text, params)
    tbl, stats = sharded_gopt.execute(opt)
    _table_eq(tbl, sharded_gopt.execute(opt, backend="numpy")[0], name)
    _table_eq(tbl, _ref_numpy(gopt_small, text, params), f"{name} (ref)")
    assert tbl.nrows > 1
    assert TransferStats.mid_plan_d2h(stats.transfers) == 0


@pytest.mark.parametrize("name,text,params", PARITY + W.TAIL_QUERIES,
                         ids=NAMES + TAIL_NAMES)
def test_sharded_ledger_equals_reference(ref_sharded, gopt_small,
                                         sharded_gopt, name, text, params):
    """Per query, the port's rows and exchange summary equal the reference
    sharded backend's at one shard: the same collectives, calls and
    elements, and every column value for value.  The reference sums AVG
    in float32 where the port sums in float64, so a floating column is
    held to the reference's ``numpy`` spec instead."""
    want_tbl, want = ref_sharded.run(text, params)
    got_tbl, got = sharded_gopt.run(text, params)
    assert got.exchanges == want.exchanges
    assert got_tbl.nrows == want_tbl.nrows
    assert set(got_tbl.cols) == set(want_tbl.cols)
    exact = _ref_numpy(gopt_small, text, params)
    for k in got_tbl.cols:
        x = np.asarray(got_tbl.cols[k])
        y = np.asarray((exact if x.dtype.kind == "f" else want_tbl).cols[k])
        assert x.dtype == y.dtype, f"{name}/{k}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{name}/{k}")


def test_sharded_expand_records_frontier_exchange(sharded_gopt):
    _, stats = sharded_gopt.run(Q.QIC["ic1"], params=Q.QIC_PARAMS["ic1"])
    assert "psum:expand_frontier" in stats.exchanges
    assert "psum_scatter:expand_emit" in stats.exchanges
    assert not any(k.startswith("all_gather") for k in stats.exchanges)


def test_sharded_blowup_guard(port_small):
    ops = _fresh_ops(port_small)
    csr = _conf_csr()
    m = ops.exchange_stats.mark()
    with pytest.raises(RuntimeError, match="blow-up"):
        ops.expand(csr, ops.asarray(np.array([1, 0, 2, 3])), max_out=2)
    # it raised after the degree exchange, before the emit collectives
    assert ops.exchange_stats.summary(m) == {
        "psum:expand_frontier": {"calls": 1, "elems": 16}}


def test_profile_renders_exchange_section(sharded_gopt):
    pq = sharded_gopt.prepare(Q.QIC["ic1"])
    rep = pq.explain(analyze=True, params=Q.QIC_PARAMS["ic1"])
    assert rep.exchanges
    text = rep.render()
    assert "-- exchanges --" in text
    assert "psum:expand_frontier" in text


def test_glogue_probes_through_the_sharded_spec(sharded_gopt, port_small):
    """GLogue's triangle counts ran on the sharded spec: its operator set
    holds blocks with K1 indexes and no whole-CSR twin."""
    ops = sharded_gopt.spec.operators(port_small)
    assert sharded_gopt.glogue.spec is sharded_gopt.spec
    assert any(blk.index is not None for _, blk in ops._blocks.values())
    assert not ops._dev


def test_glogue_frequencies_equal_reference(port_small, small_ldbc):
    """Fresh on both sides: a GLogue keeps the patterns queries look up."""
    got = GOpt(port_small, backend="sharded", devices=1, device="cpu")
    assert got.glogue.freq == RefGOpt(small_ldbc).glogue.freq


# ---------------------------------------------------------- spec pinning

def test_devices_kwarg_pins_spec(port_small):
    g = GOpt(port_small, backend="sharded", devices=2, device="cpu")
    assert g.spec.name == "sharded[2,cpu]"
    ops = g.spec.operators(port_small)
    assert ops.n_shards == 1            # clamped to the world of one
    # same count and device -> same registered spec object (memoized)
    g2 = GOpt(port_small, backend="sharded", devices=2, device="cpu")
    assert g2.spec is g.spec
    # pinned execution stays row-correct
    ref, _ = GOpt(port_small, backend="numpy").run(Q.QT["Qt1"])
    tbl, _ = g.run(Q.QT["Qt1"])
    _table_eq(tbl, ref)


def test_spec_names_do_not_mix_devices():
    assert sharded_spec(None, "cpu").name == "sharded[cpu]"
    assert sharded_spec(4, "cpu").name == "sharded[4,cpu]"
    assert sharded_spec(4, "cpu") is sharded_spec(4, torch.device("cpu"))
    assert get_spec("sharded").name == "sharded"
    assert get_spec("sharded[4,cpu]") is sharded_spec(4, "cpu")


def test_devices_kwarg_requires_sharded(port_small):
    with pytest.raises(ValueError, match="sharded"):
        GOpt(port_small, backend="numpy", devices=4)
    with pytest.raises(ValueError, match="sharded"):
        GOpt(port_small, backend="torch", devices=4, device="cpu")
    with pytest.raises(ValueError, match="device= requires"):
        GOpt(port_small, backend="numpy", device="cpu")


def test_sharded_without_a_card_raises(port_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kw in ({}, {"devices": 1}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GOpt(port_small, backend="sharded", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedOperators(port_small)


def test_release_drops_the_set_and_only_its_own_group():
    """``PhysicalSpec.release`` takes the set out of its store's cache,
    drops its blocks, and destroys the default group only if the set
    created it."""
    store = generate_motivating(n_person=30, n_product=10, n_place=4)
    had_group = dist.is_initialized()
    spec = sharded_spec(1, "cpu")
    ops = spec.operators(store)
    assert (ops._own_group is not None) == (not had_group)
    tbl, _ = GOpt(store, backend="sharded", devices=1, device="cpu").run(
        W.Q2HOP)
    assert ops._blocks and tbl.nrows
    spec.release(store)
    assert spec.name not in store._physical_ops_cache and not ops._blocks
    assert dist.is_initialized() == had_group
    # the next call builds a fresh set (and group, if it went)
    assert spec.operators(store) is not ops


# ------------------------------------------------------------- cost model

def test_cost_params_have_exchange_term():
    assert get_spec("sharded").cost.alpha_exchange > 0
    assert sharded_spec(2, "cpu").cost == get_spec("sharded").cost
    assert torch_spec("cpu").cost.alpha_exchange == 0.0
    assert get_spec("numpy").cost.alpha_exchange == 0.0


def test_exchange_term_raises_costs(sharded_gopt):
    pattern = sharded_gopt.parse(
        "Match (p:PERSON)-[:KNOWS]->(q:PERSON) Return p").pattern()
    est = CardEstimator(sharded_gopt.stats, sharded_gopt.glogue)
    base = GraphOptimizer(est, spec="sharded", alpha_exchange=0.0)
    dist = GraphOptimizer(est, spec="sharded")
    assert dist.alpha_exchange == get_spec("sharded").cost.alpha_exchange
    v = sorted(pattern.vertices)[0]
    edges = [e for e in pattern.edges if v in (e.src, e.dst)][:1]
    f_src = 100.0
    c0, _ = base._expand_cost(pattern, frozenset({edges[0].other(v)}),
                              f_src, v, edges)
    c1, _ = dist._expand_cost(pattern, frozenset({edges[0].other(v)}),
                              f_src, v, edges)
    assert c1 == pytest.approx(c0 + dist.alpha_exchange * f_src)


# ------------------------------------------------------ streamed generator

def test_streamed_ldbc_on_the_sharded_spec():
    """The streamed generator is deterministic, and the sharded spec
    answers its stores as the numpy spec does."""
    a, b = generate_ldbc_streamed(0.05), generate_ldbc_streamed(0.05)
    assert a.n_vertices == b.n_vertices and a.n_edges == b.n_edges
    q = ("Match (p:PERSON)-[:KNOWS]->(q:PERSON)-[:LIKES]->(m:POST) "
         "Return count(*)")
    ga = GOpt(a, backend="sharded", devices=1, device="cpu")
    ta, sa = ga.run(q)
    tb, _ = GOpt(b, backend="sharded", devices=1, device="cpu").run(q)
    _table_eq(ta, tb)
    assert sa.exchanges
    _table_eq(ta, GOpt(a, backend="numpy").run(q)[0])
    tbl, _ = ga.run(Q.QIC["ic1"], params=Q.QIC_PARAMS["ic1"])
    _table_eq(tbl, GOpt(a, backend="numpy").run(
        Q.QIC["ic1"], params=Q.QIC_PARAMS["ic1"])[0])


# --------------------------------------------------- K1 on the shard blocks

@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_block_probes_sum_to_the_whole_probe(port_small, n_shards, with_pos):
    """Each block's rank-local probe (one K1 call, its plain version here)
    hits only rows it owns; the hit flags and positions of all blocks sum
    to the probe of the whole CSR."""
    t = next(t for t in port_small.in_csr if t.label == "KNOWS")
    csr = port_small.in_csr[t] if with_pos else port_small.out_csr[t]
    assert (csr.pos is not None) == with_pos
    rng = np.random.default_rng(n_shards)
    n_rows = csr.indptr.shape[0] - 1
    rows = rng.integers(0, n_rows, 4096)
    slot = csr.indptr[rows] + (rng.random(4096) * np.diff(csr.indptr)[rows]
                               ).astype(np.int64)
    tgt = np.where(rng.random(4096) < 0.5,
                   csr.indices[np.minimum(slot, csr.indices.shape[0] - 1)],
                   rng.integers(0, int(csr.indices.max()) + 1, 4096))
    i32 = torch.int32
    rows_t = torch.as_tensor(rows, dtype=i32)
    tgt_t = torch.as_tensor(tgt, dtype=i32)
    want = wcoj_intersect_ref(
        torch.as_tensor(csr.indptr, dtype=i32),
        torch.as_tensor(csr.indices, dtype=i32), rows_t, tgt_t,
        torch.as_tensor(csr.pos, dtype=i32) if with_pos else None)
    sh = partition_csr(csr, n_shards)
    hits = torch.zeros(4096, dtype=i32)
    epos = torch.zeros(4096, dtype=i32)
    for r in range(n_shards):
        blk = upload_block(sh, r, lambda a: torch.as_tensor(a, dtype=i32))
        blk.index = build_search_index(blk.indices)
        hit, ep = block_probe(blk, rows_t, tgt_t)
        assert not (hit & torch.as_tensor(sh.owner_of(rows) != r)).any()
        hits += hit.to(i32)
        epos += ep
    assert want[0].any() and not want[0].all()
    assert torch.equal(hits > 0, want[0]) and int(hits.max()) == 1
    assert torch.equal(epos, want[1])


# ------------------------------------------------ gloo worlds of 2 and 4

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return W.spawn_world(2, tmp_path_factory.mktemp("world2"),
                         ("appendix", "delta"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return W.spawn_world(4, tmp_path_factory.mktemp("world4"),
                         ("appendix", "devices2"))


@pytest.fixture(scope="module")
def ref_world_cols():
    """The reference's ``numpy`` spec on the store the worlds build, from
    the reference's own generator with the same seed, on the plans the
    reference optimises for its sharded spec."""
    ref = RefGOpt(ref_generate_ldbc(sf=0.05))
    return {name: W.table_cols(_ref_numpy(ref, text, params))
            for name, text, params in PARITY + W.TAIL_QUERIES}


@pytest.fixture(scope="module")
def ref_delta():
    """The delta scenarios of the S=2 world on the reference's store, held
    to the reference's ``numpy`` spec."""
    def make(store):
        return RefGOpt(store, backend="numpy")
    return {"overlay": W.overlay_parity(make, pkg="repro"),
            "snapshot": W.snapshot_isolation(make, pkg="repro")}


@pytest.fixture(scope="module")
def one_rank_ledgers():
    """The five queries' ledgers at S=1 on the store the worlds build."""
    gopt = GOpt(generate_ldbc(sf=0.05), backend="sharded", devices=1,
                device="cpu")
    return {name: gopt.run(text, params)[1].exchanges
            for name, text, params in PARITY}


@pytest.mark.parametrize("world", [2, 4])
def test_world_group_and_shards(request, world):
    for res in request.getfixturevalue(f"world{world}"):
        app = res["appendix"]
        assert app["n_shards"] == world and app["backend"] == "gloo"
        assert app["spec"] == "sharded[cpu]"


@pytest.mark.parametrize("name", NAMES + [q[0] for q in W.TAIL_QUERIES])
@pytest.mark.parametrize("world", [2, 4])
def test_world_rows_equal_numpy_on_every_rank(request, world, name):
    ranks = request.getfixturevalue(f"world{world}")
    first = ranks[0]["appendix"]["queries"][name]
    for res in ranks:
        q = res["appendix"]["queries"][name]
        assert q["nrows"] == q["numpy_nrows"]
        _cols_eq(q["cols"], q["numpy_cols"], f"rank {res['rank']}")
        _cols_eq(q["cols"], first["cols"], f"rank {res['rank']} vs 0")
        assert q["mid_plan_d2h"] == 0
        assert q["deliver_calls"] > 0 or q["nrows"] == 0


@pytest.mark.parametrize("name", NAMES + TAIL_NAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_world_rows_equal_reference(request, ref_world_cols, world, name):
    """Every rank's rows equal the reference's ``numpy`` spec on the same
    store: the all-gathers, reduce-scatter chunks and distributed
    ``group_reduce`` partials checked against the reference package."""
    for res in request.getfixturevalue(f"world{world}"):
        _cols_eq(res["appendix"]["queries"][name]["cols"],
                 ref_world_cols[name], f"rank {res['rank']} vs reference")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_world_ledger_is_one_rank_plus_gathers(request, one_rank_ledgers,
                                               world, name):
    """S > 1 runs the same collectives as S=1, plus an all-gather of each
    reduce-scattered expand column and the tail's operand gathers; every
    rank records the same ledger."""
    ranks = request.getfixturevalue(f"world{world}")
    led = ranks[0]["appendix"]["queries"][name]["exchanges"]
    for res in ranks[1:]:
        assert res["appendix"]["queries"][name]["exchanges"] == led
    gathers = {k: v for k, v in led.items() if k.startswith("all_gather:")}
    rest = {k: v for k, v in led.items() if k not in gathers}
    assert rest == one_rank_ledgers[name]
    assert gathers.pop("all_gather:expand_replicate") == \
        led["psum_scatter:expand_emit"]
    assert {k.split(":", 1)[1] for k in gathers} <= TAIL_GATHERS


@pytest.mark.parametrize("world", [2, 4])
def test_world_rank_holds_only_its_blocks(request, world):
    for res in request.getfixturevalue(f"world{world}"):
        app = res["appendix"]
        assert app["whole_csr_twins"] == 0
        assert app["blocks"]
        for b in app["blocks"]:
            pad = 4 * ((2 if b["has_pos"] else 1) * b["nnz_cap"] + 3)
            assert b["block_bytes"] <= b["csr_bytes"] / world + pad


def test_world_of_4_pinned_to_2_shards(world4):
    for res in world4:
        d = res["devices2"]
        if res["rank"] < 2:
            assert d["n_shards"] == 2 and d["spec"] == "sharded[2,cpu]"
            assert d["rows"] == d["numpy_rows"] and d["rows"]
            # its release destroys the subgroup it made, not the world
            assert d["subgroup"] and d["released"]
            assert d["default_alive"] and not d["subgroup_alive"]
        else:
            assert "outside the sharded backend's group" in d["refused"]


def test_world_2_overlay_parity_vs_frozen_oracle(world2, ref_delta):
    for res in world2:
        for (got, want), (_, ref) in zip(res["delta"]["overlay"],
                                         ref_delta["overlay"], strict=True):
            assert got == want == ref and got


def test_world_2_snapshot_isolation_under_writes(world2, ref_delta):
    for res in world2:
        snaps = res["delta"]["snapshot"]
        assert len(snaps) == 5
        for (got, want), (_, ref) in zip(snaps, ref_delta["snapshot"],
                                         strict=True):
            assert got == want == ref
        assert len({len(g) for g, _ in snaps}) > 1   # the writes showed


def test_a_hung_world_fails_by_its_deadline(tmp_path, monkeypatch):
    """Rank 0 waits in a collective that rank 1 never joins; the parent
    kills both at the deadline and raises."""
    monkeypatch.setattr(W, "DEADLINE_S", 10)
    with pytest.raises(RuntimeError, match="killed"):
        W.spawn_world(2, tmp_path, ("stall",))

