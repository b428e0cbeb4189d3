"""Multi-process gloo worlds for the port's sharded backend
(``repro_torch.graphdb.sharded_backend``), shared by ``test_torch_sharded.py``
and ``test_torch_delta.py``.  A spawned rank imports torch and the port and
nothing else (no jax, no reference package); the parent runs the same delta
scenarios on the reference (``pkg="repro"``) to hold the ranks' rows to it.

``spawn_world(world, tmp, tasks)`` starts ``world`` ranks with the ``spawn``
method; they meet through a ``file://`` rendezvous under ``tmp`` (no port
is picked) in a gloo group with a 60 s timeout, each runs ``tasks`` and
pickles its results.  The parent joins them against a deadline and kills
the survivors, so a rank that deadlocks fails the caller instead of
running into the suite's clock.

Every rank builds the same store from a seed and runs the same plans
(SPMD): ``generate_ldbc(sf=0.05)`` for the Appendix-A queries, the
motivating graph for the delta scenarios (the twins of
``tests/test_delta.py``'s overlay-parity and snapshot-isolation tests).
"""
from __future__ import annotations

import copy
import datetime
import importlib
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

DEADLINE_S = 300        # a whole world, spawn to exit
GROUP_TIMEOUT_S = 60    # each collective of a rank

QK = """MATCH (a:PERSON)-[:knows]->(b:PERSON)
RETURN a.id AS aid, b.id AS bid ORDER BY aid, bid"""
Q2HOP = """MATCH (a:PERSON)-[:knows]->(b:PERSON)-[:knows]->(c:PERSON)
RETURN a.id AS aid, c.id AS cid, count(b) AS n ORDER BY aid, cid"""
QPROPS = """MATCH (a:PERSON)-[:purchases]->(p:PRODUCT)
RETURN a.id AS aid, p.id AS pid ORDER BY aid, pid"""


def parity_queries():
    """The reference's Appendix-A parity set (``tests/test_sharded.py``)."""
    from benchmarks import queries as Q
    return [("ic1", Q.QIC["ic1"], Q.QIC_PARAMS["ic1"]),
            ("Qc1a", Q.QC["Qc1a"], None),
            ("Qr2", Q.QR["Qr2"], None),
            ("Qt1", Q.QT["Qt1"], None),
            ("ic5", Q.QIC["ic5"], Q.QIC_PARAMS["ic5"])]


# the relational tail's other collectives: every aggregate (SUM / AVG /
# MIN / MAX partials), DISTINCT, a multi-key ORDER BY and a join of two
# patterns
TAIL_QUERIES = [
    ("aggregates", "MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
     "WHERE p.id IN [1,2,3,4,5,6,7,8] AND NOT f.id = 4 RETURN p, "
     "sum(f.id) AS s, avg(f.id) AS a, min(f.id) AS lo, max(f.id) AS hi, "
     "count(f) AS n ORDER BY p", None),
    ("distinct", "MATCH (p:PERSON)-[k:KNOWS]->(f:PERSON) "
     "WHERE k.creationDate > 1300000000 RETURN DISTINCT f ORDER BY f "
     "LIMIT 50", None),
    ("order_two_keys", "MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
     "WHERE p.id < 40 RETURN p.id AS pid, f.id AS fid "
     "ORDER BY fid DESC, pid LIMIT 64", None),
]


def table_cols(tbl) -> dict:
    return {k: np.asarray(v) for k, v in tbl.cols.items()}


def rows(tbl) -> list:
    ks = sorted(tbl.cols)
    if tbl.nrows == 0:
        return []
    return sorted(zip(*[np.asarray(tbl.cols[k]).tolist() for k in ks]))


# ------------------------------------------------------------ delta scenarios

def _mutable(pkg: str = "repro_torch"):
    """The motivating graph and a mutable store over it, from ``pkg``: the
    port, or the reference in the parent."""
    delta = importlib.import_module(f"{pkg}.graphdb.delta")
    ldbc = importlib.import_module(f"{pkg}.graphdb.ldbc")
    base = ldbc.generate_motivating(n_person=50, n_product=20, n_place=8)
    return base, delta.MutableGraphStore(base)


def _gopt_class(pkg: str):
    return importlib.import_module(f"{pkg}.core.gopt").GOpt


def _knows(base):
    return next(t for t in base.out_csr if t.label == "KNOWS")


def _apply_mix(ms, base, n=6):
    """The reference's deterministic insert/delete mix
    (``tests/test_delta.py::_apply_mix``)."""
    kt = _knows(base)
    off = base.v_offset["PERSON"]
    new = []
    for i in range(n):
        gid = ms.insert_vertex("PERSON", {"id": 9000 + i})
        new.append(gid)
        ms.insert_edge(kt, off + i, gid)
    for i in range(1, n):
        ms.insert_edge(kt, new[i - 1], new[i])
    csr = base.out_csr[kt]
    row = int(np.argmax(np.diff(csr.indptr)))
    ms.delete_edge(kt, off + row, int(csr.indices[csr.indptr[row]]))
    ms.delete_vertex(new[-1])
    return new


def overlay_parity(make_gopt, pkg: str = "repro_torch") -> list:
    """With a live overlay (inserts and tombstones), ``(got, want)`` row
    lists of three queries: ``make_gopt(store)`` on the mutable store
    against ``pkg``'s numpy spec on a frozen deep copy."""
    GOpt = _gopt_class(pkg)
    base, ms = _mutable(pkg)
    _apply_mix(ms, base)
    frozen = copy.deepcopy(ms)
    gopt, oracle = make_gopt(ms), GOpt(frozen, backend="numpy")
    return [(rows(gopt.run(q)[0]), rows(oracle.run(q)[0]))
            for q in (QK, Q2HOP, QPROPS)]


def snapshot_isolation(make_gopt, pkg: str = "repro_torch") -> list:
    """A query pinned at snapshot S answers as-of S while inserts and
    deletes land: ``(got, want)`` row lists per snapshot, ``want`` from
    ``pkg``'s numpy spec on a deep copy taken at S."""
    GOpt = _gopt_class(pkg)
    base, ms = _mutable(pkg)
    kt = _knows(base)
    csr = base.out_csr[kt]
    off = base.v_offset["PERSON"]
    gopt = make_gopt(ms)
    snaps = []
    for i in range(4):
        snaps.append((gopt.snapshot(), copy.deepcopy(ms)))
        gid = ms.insert_vertex("PERSON", {"id": 8800 + i})
        ms.insert_edge(kt, off + i, gid)
        row = int(np.argsort(np.diff(csr.indptr))[-(i + 1)])
        if csr.indptr[row] < csr.indptr[row + 1]:
            ms.delete_edge(kt, off + row, int(csr.indices[csr.indptr[row]]))
        if i == 2:
            ms.delete_vertex(gid)
    snaps.append((gopt.snapshot(), copy.deepcopy(ms)))
    return [(rows(gopt.run(QK, snapshot=snap)[0]),
             rows(GOpt(frozen, backend="numpy").run(QK)[0]))
            for snap, frozen in snaps]


def sharded_cpu(store):
    """``make_gopt`` for the sharded spec on the CPU (every rank)."""
    from repro_torch.core.gopt import GOpt
    return GOpt(store, backend="sharded", device="cpu")


# ------------------------------------------------------------- one rank's work

def _appendix(world: int) -> dict:
    import torch.distributed as dist
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.physical_spec import TransferStats
    from repro_torch.graphdb.ldbc import generate_ldbc
    store = generate_ldbc(sf=0.05)
    gopt = GOpt(store, backend="sharded", device="cpu")
    ops = gopt.spec.operators(store)
    out = {"n_shards": ops.n_shards, "spec": gopt.spec.name,
           "backend": dist.get_backend(ops.group), "queries": {}}
    for name, text, params in parity_queries() + TAIL_QUERIES:
        opt = gopt.optimize(text, params)
        tbl, st = gopt.execute(opt)
        want, _ = gopt.execute(opt, backend="numpy")
        out["queries"][name] = {
            "cols": table_cols(tbl), "nrows": tbl.nrows,
            "numpy_cols": table_cols(want), "numpy_nrows": want.nrows,
            "exchanges": st.exchanges,
            "mid_plan_d2h": TransferStats.mid_plan_d2h(st.transfers),
            "deliver_calls": st.transfers.get("deliver:d2h", {}).get(
                "calls", 0)}
    # the device bytes of every block this rank holds, beside its CSR's
    blocks = []
    for ref, blk in ops._blocks.values():
        csr = ref()
        if csr is None:
            continue
        words = csr.indptr.size + csr.indices.size + (
            csr.pos.size if csr.pos is not None else 0)
        blocks.append({"block_bytes": blk.nbytes() - (
            blk.index.numel() * 4 if blk.index is not None else 0),
            "csr_bytes": 4 * words, "nnz_cap": int(blk.indices.shape[0]),
            "has_pos": csr.pos is not None,
            "rows_per_shard": blk.rows_per_shard})
    out["blocks"] = blocks
    out["whole_csr_twins"] = len(ops._dev)
    return out


def _devices2() -> dict:
    """A world of 4 pinned to 2 shards: ranks 0-1 answer, 2-3 refuse.
    Then ranks 0-1 release the set: its subgroup goes, the default group
    stays."""
    import torch.distributed as dist
    from repro_torch.core.gopt import GOpt
    base, ms = _mutable()
    try:
        gopt = GOpt(base, backend="sharded", devices=2, device="cpu")
    except ValueError as exc:
        return {"refused": str(exc)}
    ops = gopt.spec.operators(base)
    out = {"n_shards": ops.n_shards, "spec": gopt.spec.name,
           "rows": rows(gopt.run(Q2HOP)[0]),
           "numpy_rows": rows(GOpt(base, backend="numpy").run(Q2HOP)[0]),
           "subgroup": ops.group is not dist.group.WORLD}
    group = ops.group
    gopt.spec.release(base)
    out["released"] = (gopt.spec.name not in base._physical_ops_cache
                       and not ops._blocks)
    out["default_alive"] = dist.is_initialized()
    try:
        dist.get_backend(group)     # raises once the group is destroyed
        out["subgroup_alive"] = True
    except (ValueError, KeyError, RuntimeError):
        out["subgroup_alive"] = False
    return out


def _stall(world: int) -> None:
    """Rank 0 enters a collective that rank 1 never joins: a deadlock."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(3600)


# ------------------------------------------------------------------- elastic

# the tiny LM of tests/test_train_substrate.py, trained in float32
ELASTIC_CFG = dict(name="tiny", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab_size=61, block_q=8,
                   block_kv=8)
WORKDIR = None          # this world's directory; the test's is its parent


def _elastic(src: str, dst: str | None) -> dict:
    """Restore the newest checkpoint under ``src`` into a fresh state of
    the tiny LM and place it on this world's ``(world, 1)`` host mesh with
    the LM bundle's training shardings (``elastic_restart``); with ``dst``
    save the placed (DTensor) state there (every rank gathers, rank 0
    writes).  Returns the step, each leaf's local shape and its gathered
    values."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import tree_leaves
    from repro_torch.configs.lm_common import LMBundle
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import elastic_restart
    cfg = tfm.TransformerConfig(**ELASTIC_CFG, dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(99),
                            device="cpu")
    like = (model, opt.init(opt.AdamWConfig(), model.parameters()))
    bundle = LMBundle(cfg)
    root = Path(WORKDIR).parent
    step, placed = elastic_restart(
        CheckpointManager(str(root / src), async_write=False), like,
        make_host_mesh("cpu"),
        lambda mesh: bundle.shardings(mesh, "train_4k")[0][:2])
    leaves = tree_leaves(placed)
    out = {"step": step,
           "local_shapes": [tuple(d.to_local().shape) for d in leaves],
           "values": [d.full_tensor().numpy() for d in leaves]}
    if dst is not None:
        rank = dist.get_rank()
        where = root / (dst if rank == 0 else f"{dst}_rank{rank}")
        CheckpointManager(str(where), async_write=False).save(step, placed)
    return out


TASKS = {
    "elastic_save": lambda world: _elastic("ref_ckpt", "ckpt_on_4"),
    "elastic_restore": lambda world: _elastic("ckpt_on_4", None),
    "appendix": _appendix,
    "delta": lambda world: {
        "overlay": overlay_parity(sharded_cpu),
        "snapshot": snapshot_isolation(sharded_cpu)},
    "devices2": lambda world: _devices2(),
    "stall": _stall,
}


def _rank_main(rank: int, world: int, tmp: str, tasks: tuple) -> None:
    global WORKDIR
    WORKDIR = tmp
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{Path(tmp) / 'rendezvous'}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        res = {"rank": rank}
        for task in tasks:
            t0 = time.perf_counter()
            res[task] = TASKS[task](world)
            res[f"{task}_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
    except BaseException:
        res = {"rank": rank, "error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def spawn_world(world: int, tmp, tasks: tuple) -> list[dict]:
    """Run ``tasks`` on ``world`` spawned ranks; returns each rank's
    results.  Raises ``RuntimeError`` with the ranks' tracebacks if one
    failed, or if the world outlived ``DEADLINE_S`` (its ranks killed)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp), tuple(tasks)),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise RuntimeError(f"ranks {hung} of a world of {world} still ran "
                           f"after {DEADLINE_S} s (killed)")
    results = []
    for r in range(world):
        path = tmp / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"rank {r} exited with code "
                               f"{procs[r].exitcode} and no result")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    errors = [f"rank {r['rank']}:\n{r['error']}" for r in results
              if "error" in r]
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
