"""Fused chains replayed as CUDA graphs (``graphdb/torch_backend.py``
``_Program``).

Every bucketed chain program reads its run values from static buffers
(the padded source column, the source count as a device scalar, the
scalar slots and the sorted, padded IN-sets in one packed buffer).  On
cuda it runs eagerly at its key's first dispatch, is captured then as a
CUDA graph and replayed at every later dispatch; on the CPU, here, it runs
eagerly.  The CPU tests hold it bit for bit to the eager program over
``torch.isin``, a Python-int source count and the IN-sets as they came
(``_reference``), on random chains and on the benchmark's suite, and a CPU
set attempts no capture and counts what it always counted.  The tests
marked ``gpu`` hold the graphs themselves to the eager program on the
card; they skip themselves without one.  The file imports neither jax nor
the reference package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_chain_graphs.py
"""
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.physical_spec import KernelStats, TransferStats
from repro_torch.graphdb import torch_backend, torchops
from repro_torch.graphdb.engine import Engine
from repro_torch.graphdb.torch_backend import TorchOperators, _Program
from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                    wcoj_intersect)

SCALE = 0.5                 # the frozen generator's scale for the suite
SEED = 2147483917
I32 = torch.int32

# a chain whose source count and IN-set come from parameters: the scan
# keeps the persons of $src, the chain's last hop tests g.firstName IN
# $names (eight first names: a set of more values holds the others)
IN_CHAIN = ("MATCH (p:PERSON)-[:KNOWS]->(f:PERSON)-[:KNOWS]->(g:PERSON) "
            "WHERE p.id IN $src AND g.firstName IN $names "
            "RETURN g, count(p) AS c ORDER BY c DESC, g LIMIT 50")
# source counts 5, 7 and 6 (one input bucket, 8), sets of 4, 5 (with a
# duplicate and values no vertex holds), 40 and 0 values (buckets 4, 8,
# 64 and the empty variant)
IN_RUNS = [{"src": [1, 2, 3, 4, 5], "names": [1, 2, 3, 4]},
           {"src": [1, 2, 3, 4, 5], "names": [1, 2, 3, 4]},
           {"src": [1, 2, 3, 4, 5, 6, 7], "names": [1, 2, 3, 4]},
           {"src": [9, 8, 7, 6, 5, 4, 3], "names": [3, 3, 5, -1, 10 ** 9]},
           {"src": [1, 2, 3, 4, 5, 6], "names": list(range(-10, 30))},
           {"src": [1, 2, 3, 4, 5, 6, 7], "names": []},
           {"src": [1, 2, 3, 4, 5, 6, 7], "names": [1, 2, 3, 4]}]


# ---------------------------------------------------------------- helpers

def _suite(scale: float, device):
    """The benchmark's store at a small generator scale, ``GOpt`` on
    ``device`` (None: cuda), its suite and its row cap."""
    from perfbench import bench, harness, system
    spec = bench.load()
    cell = spec["workloads"][0]
    cfg = dict(bench.config(spec, cell["config"]), generator_scale=scale)
    qs = harness.queries()
    suite = [(n, qs[n]["text"], qs[n]["params"])
             for n in bench.traffic(cell["traffic"])["queries"]]
    return system.build(cfg, SEED, device).gopt, suite, cfg["max_rows"]


def _table_eq(a, b, msg=""):
    assert a.nrows == b.nrows, f"{msg}: {a.nrows} != {b.nrows}"
    assert set(a.cols) == set(b.cols), msg
    for k in a.cols:
        np.testing.assert_array_equal(np.asarray(a.cols[k]),
                                      np.asarray(b.cols[k]),
                                      err_msg=f"{msg}/{k}")


def _outputs_equal(a, b, msg=""):
    """Two runs of a chain program: columns, order, count and totals."""
    (ca, oa, na, da), (cb, ob, nb, db) = a, b
    assert set(ca) == set(cb), msg
    for k in ca:
        assert ca[k].dtype == cb[k].dtype and torch.equal(ca[k], cb[k]), \
            f"{msg}/{k}"
    for x, y, what in ((oa, ob, "order"), (na, nb, "n_valid"),
                       (da, db, "needed")):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{msg}/{what}"


def _run(gopt, ops, text, params, max_rows=100_000_000):
    """One run of ``text``'s prepared plan through the set ``ops``."""
    opt = gopt.prepare(text, params).opt
    return Engine(gopt.store, backend=ops, max_rows=max_rows).run(
        opt.logical, opt.physical, params=params)


def _programs(ops):
    return [(chain, key, prog) for chain in ops._chains.values()
            for key, prog in chain._progs.items()]


def _reference(desc, caps, in_bucket, empties, src, n0, inputs, scalars,
               values):
    """The chain program as it ran before static buffers: a Python-int
    source count and membership by ``torch.isin`` over each IN-set as
    given."""
    fn = torchops.build_fused_chain(desc, caps, in_bucket, wcoj_intersect,
                                    empty_values=empties)
    with mock.patch.object(torchops, "sorted_isin", torch.isin):
        return fn(src, int(n0), *inputs, scalars, values)


def _program_equals_reference(chain, key, prog, msg=""):
    """A suite program's last run, eager on its own buffers, against
    ``_reference`` on the same values (the padded sets hold the same
    members as the sets that came)."""
    caps, in_bucket, _, empties = key
    desc = chain._build_desc()[0]
    src, n0, *inputs, scal, vals = prog.args
    _outputs_equal(prog.fn(*prog.args),
                   _reference(desc, caps, in_bucket, empties, src, n0,
                              inputs, scal, vals), msg)


# --------------------------------------------- the sync-free IN-set test

@pytest.mark.parametrize("case", range(8))
def test_sorted_isin_equals_isin(case):
    """``sorted_isin`` over a set sorted and padded by repeating its
    largest value is ``torch.isin`` over the set as it came: duplicates,
    negatives, the int32 extremes and values outside the set's range."""
    g = torch.Generator().manual_seed(case)
    lo, hi = [(-3, 3), (0, 50), (-1000, 1000), (0, 2)][case % 4]
    k = [1, 3, 17, 64][case // 2 % 4]
    s = torch.randint(lo, hi, (k,), generator=g, dtype=I32)
    x = torch.randint(lo - 5, hi + 5, (200,), generator=g, dtype=I32)
    extremes = torch.tensor([-2 ** 31, 2 ** 31 - 1, lo - 1, hi], dtype=I32)
    x = torch.cat([x, extremes, s])
    if case == 7:
        s = torch.cat([s, torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=I32)])
    srt = torch.sort(s).values
    pad = 1 << max(k - 1, 0).bit_length()
    padded = torch.cat([srt, srt[-1:].expand(pad + 3 - srt.shape[0])])
    for t in (srt, padded):
        assert torch.equal(torchops.sorted_isin(x, t), torch.isin(x, s))
    assert torchops.sorted_isin(x[:0], srt).shape == (0,)


# ---------------------------------------------- random chains, both forms

V = 40                      # vertices; two keyed types, [0, 20) and [20, 40)


def _csr(rng, lo, hi, has_pos):
    rows = hi - lo
    deg = rng.integers(0, 5, rows)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(V, d, replace=False))
                              for d in deg] or [np.zeros(0)]
                             ).astype(np.int32)
    t = [torch.from_numpy(indptr), torch.from_numpy(indices)]
    pos = (torch.from_numpy(rng.permutation(len(indices)).astype(np.int32))
           if has_pos else None)
    return t[0], t[1], pos, build_search_index(t[1])


def _random_chain(seed: int):
    """A random chain program's description and its inputs: 2-3 hops of
    one or two orientations, a probe on the last hop, and predicates over
    an IN-set, a vertex property and an edge property."""
    rng = np.random.default_rng(seed)
    hops, csrs, carried = [], [], ["s"]
    n_hops = int(rng.integers(2, 4))
    for k in range(n_hops):
        frm = str(rng.choice(carried))
        orients, oc = [], []
        for j in range(int(rng.integers(1, 3))):
            lo, hi = [(0, 20), (20, 40), (0, 40)][int(rng.integers(3))]
            has_pos = bool(rng.integers(2))
            orients.append((lo, hi, j, has_pos))
            oc.append(_csr(rng, lo, hi, has_pos))
        probes, pc = [], []
        if k == n_hops - 1 and rng.integers(2):
            lo, hi = (0, 20)
            probes.append((carried[0], f"q{k}", lo, hi, 0, V, 1, True))
            pc.append(_csr(rng, lo, hi, True))
        alias = f"v{k}"
        pred = [None,
                ("in", ("col", alias), 0),
                ("cmp", ">", ("vprop", alias, 0), 0),
                ("and", (("in", ("col", alias), 0),
                         ("cmp", "<=", ("eprop", f"e{k}", 0), 1))),
                ("or", (("not", (("in", ("vprop", frm, 0), 0),)),
                        ("cmp", "=", ("col", alias), 1)))][
            int(rng.integers(5))]
        hops.append((frm, alias, f"e{k}", tuple(orients), tuple(probes),
                     pred))
        csrs.append((tuple(oc), tuple(pc)))
        carried.append(alias)
    caps = tuple(1 << int(rng.integers(3, 8)) for _ in hops)
    vprop = torch.from_numpy(rng.integers(-50, 50, V).astype(np.int32))
    eflat = torch.from_numpy(rng.integers(-50, 50, 60).astype(np.int32))
    eoffs = torch.tensor([0, 30], dtype=I32)
    return (("s", tuple(hops)), caps, tuple(csrs), (vprop,),
            ((eoffs, eflat),), rng)


def _eager(desc, caps, in_bucket, src, n, csrs, vp, ep, scalars, values,
           empties):
    padded = torch.cat([src, src.new_zeros(in_bucket - n)])
    vals = tuple(torch.tensor(v if len(v) else [0], dtype=I32)
                 for v in values)
    return _reference(desc, caps, in_bucket, empties, padded, n,
                      (csrs, vp, ep), torch.tensor(scalars, dtype=I32), vals)


@pytest.mark.parametrize("seed", range(10))
def test_static_program_equals_eager_on_random_chains(seed):
    """One static program of a bucket (``_Program``: staged source, the
    count as a device scalar, sorted padded IN-sets, ``sorted_isin``) run
    three times with other counts and IN-sets in the same buckets: each
    run equals ``_reference`` on that run's values, bit for bit."""
    desc, caps, csrs, vp, ep, rng = _random_chain(seed)
    in_bucket = 16
    ops = types.SimpleNamespace(device=torch.device("cpu"),
                                transfer_stats=TransferStats(),
                                kernel_stats=KernelStats())
    prog = _Program(desc, caps, in_bucket, (), (), ())
    vb = (16,)
    for run in range(3):
        n = int(rng.integers(9, in_bucket + 1))
        src = torch.from_numpy(rng.integers(0, V, n).astype(np.int32))
        k = int(rng.integers(1, 17))                     # 0-15 pads
        values = [rng.integers(-3, V + 3, k).tolist()]  # duplicates too
        scalars = [int(rng.integers(-50, 50)) for _ in range(2)]
        prog.stage(ops, src, n, (csrs, vp, ep), scalars, values, in_bucket,
                   vb)
        got = prog.launch(ops)
        want = _eager(desc, caps, in_bucket, src, n, csrs, vp, ep, scalars,
                      values, ())
        _outputs_equal(got, want, f"seed {seed} run {run}")
        assert prog.graph is None and prog.capture_error is None
    # one staging copy a run: the scalars and the set, packed
    assert ops.transfer_stats.count("h2d") == 3


# ------------------------------------------------- the suite on the CPU

@pytest.fixture(scope="module")
def suite_cpu():
    return _suite(SCALE, "cpu")


def test_static_chains_equal_eager_chains_on_the_suite(suite_cpu):
    """Every suite query, three runs, through a CPU set: the numpy spec's
    rows, the host syncs the eager programs made (``SUITE_SYNCS``), and
    every program it built equal to ``_reference`` on its last run."""
    gopt, suite, max_rows = suite_cpu
    ops = TorchOperators(gopt.store, device="cpu")
    fused = 0
    for rep in range(3):
        for name, text, params in suite:
            a, sa = _run(gopt, ops, text, params, max_rows)
            if rep:                 # the set staged its columns in run 0
                assert sa.host_syncs == SUITE_SYNCS[name], name
                fused += (sa.kernels or {}).get("dispatch:fused_chain", 0)
            else:
                h, _ = _run(gopt, "numpy", text, params, max_rows)
                _table_eq(a, h, f"{name} numpy")
    # 16 of the 19 queries run a chain here (not Qr3, Qr4, Qr5), fused
    # once it is measured
    assert fused == 2 * 16
    progs = _programs(ops)
    assert len(progs) == 15         # two queries share one chain's program
    for chain, key, prog in progs:
        _program_equals_reference(chain, key, prog, chain.spec.source)


def test_static_chains_take_each_runs_values(suite_cpu):
    """Source counts in one input bucket and changed IN-sets (a
    duplicate, values no vertex holds, a larger bucket, an empty set) each
    give their own answer: the numpy spec's rows and ``_reference``'s
    outputs."""
    gopt, _, max_rows = suite_cpu
    ops = TorchOperators(gopt.store, device="cpu")
    rows = []
    for i, params in enumerate(IN_RUNS):
        b, sb = _run(gopt, ops, IN_CHAIN, params, max_rows)
        h, _ = _run(gopt, "numpy", IN_CHAIN, params, max_rows)
        _table_eq(b, h, f"run {i} numpy")
        if sb.kernels.get("dispatch:fused_chain"):
            k = len(params["names"])
            bucket = (8, (torch_backend._pow2(max(k, 1)),),
                      () if k else (0,))
            (chain,) = ops._chains.values()
            key = [key for key in chain._progs if key[1:] == bucket][-1]
            _program_equals_reference(chain, key, chain._progs[key],
                                      f"run {i}")
        rows.append(b.nrows)
    assert rows[1:5] == [50] * 4 and rows[5] == 0, rows
    keys = {key[1:] for _, key, _ in _programs(ops)}
    assert {(8, (4,), ()), (8, (8,), ()), (8, (64,), ()),
            (8, (1,), (0,))} <= keys, keys


# the counts a CPU set recorded with the eager chain programs before static
# buffers, at SCALE and SEED: host syncs of a warm run, and some kernels
SUITE_SYNCS = {"Qt1": 3, "Qt2": 3, "Qt3": 3, "Qt5": 3, "Qr1": 3, "Qr2": 3,
               "Qr3": 4, "Qr4": 5, "Qr5": 4, "Qr6": 4, "Qc1a": 3, "Qc1b": 3,
               "Qc2a": 9, "Qc3b": 3, "Qc4b": 12, "ic1": 5, "ic3": 5,
               "ic11": 6, "ic12": 5}
SUITE_KERNELS = {
    "Qt1": {"dispatch:fused_chain": 1, "dispatch:group": 1},
    "Qr1": {"probe:fused_chain": 1, "dispatch:fused_chain": 1,
            "dispatch:group": 1},
    "Qr3": {"dispatch:expand": 2, "dispatch:group": 1},
    "Qc4b": {"probe:fused_chain": 1, "dispatch:fused_chain": 1,
             "dispatch:expand": 2, "dispatch:nonzero": 7,
             "dispatch:intersect": 3, "dispatch:group": 1},
    "ic12": {"dispatch:nonzero": 1, "dispatch:fused_chain": 1,
             "dispatch:group": 1},
}


def test_cpu_sets_attempt_no_capture(suite_cpu):
    """A CPU set runs its chain programs eagerly: no graph pool, no
    graph, no capture or replay events, the probes the programs made
    counted as ``probe:fused_chain``, and the counts eager chain programs
    recorded before static buffers."""
    gopt, suite, max_rows = suite_cpu
    ops = gopt.spec.operators(gopt.store)
    mark = ops.kernel_stats.mark()
    got = {}
    for _ in range(3):              # the last pass runs warm programs
        for name, text, params in suite:
            _, st = gopt.run(text, params, max_rows=max_rows)
            got[name] = st.kernels
    for name, want in SUITE_KERNELS.items():
        assert got[name] == want, name
    assert ops._graphs is None
    progs = [p for _, _, p in _programs(ops)]
    assert all(p.graph is None and p.capture_error is None for p in progs)
    events = ops.kernel_stats.events[mark:]
    assert not [e for e in events if e[0] in ("capture", "replay",
                                              "capture_failed")]
    assert sum(n for k, _, n in events if k == "probe") == \
        sum(p.probes for p in progs) > 0


# ------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def suite_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return _suite(1.0, None)


@pytest.mark.gpu
def test_chain_graphs_replay_the_eager_program(card, suite_card):
    """Every suite query with a chain, four runs on cuda: the first
    measures the chain on the loop, the second captures its program, the
    rest replay it.  Rows equal the numpy spec's and a CPU set's (whose
    programs all run eagerly); one capture a key and a replay every later
    dispatch; ``probe:fused_chain`` equals the CPU set's run for run, and
    K1 launched once for each probe, in a chain or an intersect; and each
    graph's outputs are ``torch.equal`` to its program run eagerly on the
    same buffers."""
    gopt, suite, max_rows = suite_card
    ops = gopt.spec.operators(gopt.store)
    cpu = TorchOperators(gopt.store, device="cpu")
    totals = {"capture": 0, "replay": 0, "dispatch": 0}
    for rep in range(4):
        for name, text, params in suite:
            launched = dict(kernels.LAUNCHES)
            a, sa = _run(gopt, ops, text, params, max_rows)
            torch.cuda.synchronize()
            ran = {k: kernels.LAUNCHES.get(k, 0) - launched.get(k, 0)
                   for k in ("wcoj_intersect", "wcoj_intersect.fence",
                             "wcoj_intersect.search")}
            b, sb = _run(gopt, cpu, text, params, max_rows)
            _table_eq(a, b, name)
            ka, kb = sa.kernels or {}, sb.kernels or {}
            assert not [k for k in ka if k.startswith("capture_failed")]
            for key in ("probe:fused_chain", "dispatch:fused_chain",
                        "dispatch:intersect"):
                assert ka.get(key, 0) == kb.get(key, 0), (name, key)
            probes = (kb.get("probe:fused_chain", 0)
                      + kb.get("dispatch:intersect", 0))
            assert ran["wcoj_intersect"] == probes == (
                ran["wcoj_intersect.fence"]
                + ran["wcoj_intersect.search"]), (name, ran, probes)
            if rep == 0:
                h, _ = _run(gopt, "numpy", text, params, max_rows)
                _table_eq(a, h, f"{name} numpy")
            if rep >= 2 and ka.get("dispatch:fused_chain"):
                assert ka.get("replay:fused_chain") == \
                    ka["dispatch:fused_chain"], (name, rep, ka)
                assert "capture:fused_chain" not in ka, (name, rep)
            for k in totals:
                totals[k] += ka.get(f"{k}:fused_chain", 0)
    progs = [p for _, _, p in _programs(ops)]
    assert totals["capture"] == len(progs) >= 15
    assert totals["replay"] == totals["dispatch"] - totals["capture"]
    for chain, key, prog in _programs(ops):
        assert prog.graph is not None, (key, prog.capture_error)
        want = prog.fn(*prog.args)
        prog.graph.replay()
        torch.cuda.synchronize()
        _outputs_equal(prog.outs, want, f"{chain.spec.source} {key}")


@pytest.mark.gpu
def test_chain_graphs_take_each_runs_values(card, suite_card):
    """Source counts in one input bucket and changed IN-sets each give
    their own answer on the card (nothing of a run is baked into a
    graph): the numpy spec's rows."""
    gopt, _, max_rows = suite_card
    ops = TorchOperators(gopt.store, device="cuda")
    for rep in range(3):
        for i, params in enumerate(IN_RUNS):
            a, sa = _run(gopt, ops, IN_CHAIN, params, max_rows)
            h, _ = _run(gopt, "numpy", IN_CHAIN, params, max_rows)
            _table_eq(a, h, f"pass {rep} run {i}")
            if rep == 2:    # the capacities settled in the first pass
                assert sa.kernels.get("replay:fused_chain") == \
                    sa.kernels.get("dispatch:fused_chain"), (i, sa.kernels)
    assert not [p.capture_error for _, _, p in _programs(ops)
                if p.capture_error]


def _one_chain(gopt, name, suite, max_rows, runs=3):
    """A fresh cuda set that has run query ``name`` ``runs`` times: the
    set, its one chain handle, that handle's one program and the rows."""
    ops = TorchOperators(gopt.store, device="cuda")
    _, text, params = next(q for q in suite if q[0] == name)
    for _ in range(runs):
        want, _ = _run(gopt, ops, text, params, max_rows)
    (chain,) = ops._chains.values()
    (prog,) = chain._progs.values()
    return ops, chain, prog, (text, params), want


@pytest.mark.gpu
def test_chain_graph_recaptures_after_its_csr_is_restaged(card,
                                                          suite_card):
    """A CSR's device twin dropped from the cache and staged anew: the
    next dispatch captures again over the new tensors instead of
    replaying a graph that reads the old ones."""
    gopt, suite, max_rows = suite_card
    ops, chain, prog, q, want = _one_chain(gopt, "Qc1a", suite, max_rows)
    assert prog.graph is not None, prog.capture_error
    csr = chain.spec.hops[-1].probes[0].orient.csr
    old = ops._dev.pop(id(csr))[1]
    got, st = _run(gopt, ops, *q, max_rows)
    _table_eq(got, want, "Qc1a")
    assert st.kernels.get("capture:fused_chain") == 1, (
        st.kernels, prog.capture_error)
    assert not any(t is o for t in prog.refs for o in old if o is not None)
    got, st = _run(gopt, ops, *q, max_rows)
    _table_eq(got, want, "Qc1a")
    assert st.kernels.get("replay:fused_chain") == 1, st.kernels


@pytest.mark.gpu
def test_chain_graph_capacity_overflow_falls_back_to_the_loop(card,
                                                              suite_card):
    """Capacities cut below what a chain needs: the new key's eager run
    overflows them, the run falls back to the per-hop loop with the right
    rows and captures nothing, and the regrown capacities (the first
    key's again) replay its graph."""
    gopt, suite, max_rows = suite_card
    ops, chain, prog, q, want = _one_chain(gopt, "Qt1", suite, max_rows)
    caps = chain.caps
    chain.caps = tuple(8 for _ in caps)
    got, st = _run(gopt, ops, *q, max_rows)
    _table_eq(got, want, "Qt1")
    assert st.fallbacks.get("chain_capacity") == 1, st.fallbacks
    assert "capture:fused_chain" not in st.kernels, st.kernels
    assert chain.caps == caps
    got, st = _run(gopt, ops, *q, max_rows)
    _table_eq(got, want, "Qt1")
    assert st.kernels.get("replay:fused_chain") == 1, st.kernels
    assert not st.fallbacks, st.fallbacks


@pytest.mark.gpu
def test_failed_capture_runs_eagerly_and_is_counted(card, suite_card,
                                                    monkeypatch):
    """A probe that syncs while its stream captures: the capture fails,
    the key is counted once (``capture_failed:fused_chain``) and runs its
    program eagerly with the right rows from then on, and keys without a
    probe still capture and replay."""
    gopt, suite, max_rows = suite_card
    real = torch_backend.wcoj_intersect

    def syncing(*args):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return real(*args)

    monkeypatch.setattr(torch_backend, "wcoj_intersect", syncing)
    ops = TorchOperators(gopt.store, device="cuda")
    eager = TorchOperators(gopt.store, device="cpu")
    chosen = [q for q in suite if q[0] in ("Qr1", "Qc1a", "Qt1", "Qt2")]
    mark = ops.kernel_stats.mark()
    for rep in range(3):
        for name, text, params in chosen:
            a, sa = _run(gopt, ops, text, params, max_rows)
            b, _ = _run(gopt, eager, text, params, max_rows)
            _table_eq(a, b, name)
            k = sa.kernels or {}
            if name in ("Qr1", "Qc1a"):
                # a failed key: eager, its probes counted, never replayed
                assert "replay:fused_chain" not in k, (name, k)
                if k.get("dispatch:fused_chain"):
                    assert k.get("probe:fused_chain", 0) >= 1, (name, k)
            elif rep == 2:
                assert k.get("replay:fused_chain") == 1, (name, k, [
                    p.capture_error for _, _, p in _programs(ops)])
    progs = _programs(ops)
    probed = [p for c, _, p in progs if any(h.probes for h in c.spec.hops)]
    plain = [p for c, _, p in progs if p not in probed]
    assert probed and plain
    errors = [p.capture_error for p in probed]
    assert all(e and ("synchron" in e.lower() or "captur" in e.lower())
               for e in errors), errors
    assert all(p.graph is None for p in probed)
    assert all(p.graph is not None and p.capture_error is None
               for p in plain)
    assert ops.kernel_stats.count("capture_failed", since=mark) == \
        len(probed)
    assert ops.kernel_stats.count("capture", since=mark) == len(plain)
