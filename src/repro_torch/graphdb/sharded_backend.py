"""Sharded backend over ``torch.distributed``: row-partitioned CSRs and
collective operators, one process per device.

The twin of the reference's ``ShardedOperators``
(``repro/graphdb/sharded_backend.py``, DESIGN.md §10), which is one
single-controller ``shard_map`` program over a mesh.  Here every rank runs
the same plan over the same host store (SPMD: each rank builds the same
``GOpt`` and calls the same operators in the same order), and the operator
set makes the collectives.  Each CSR is vertex-cut partitioned
(``graphdb.partition``): shard ``s`` owns a contiguous range of its keyed
rows, and rank ``s`` uploads only its own block (``indptr[s]``,
``indices[s]``, ``pos[s]``, ``edge_base[s]``), so a rank's CSR bytes on the
device are about 1/S of the whole.  The reference's collectives map to:

    psum                    -> dist.all_reduce(SUM)
    psum_scatter(tiled)     -> dist.reduce_scatter_tensor
    all_gather(tiled)       -> dist.all_gather_into_tensor
    pmin / pmax             -> dist.all_reduce(MIN / MAX)

- **expand** — each rank contributes the degrees of the frontier rows it
  owns and an all-reduce makes the degree vector replicated (the frontier
  exchange); the total is read once and the blow-up guard raises before
  any output is allocated.  Then each rank fills its owned slots of zeroed
  ``[out_cap]`` buffers at their row-major offsets and a reduce-scatter
  combines them.  The reference's next program reads that sharded output
  and XLA gathers it implicitly; torch has no global sharded tensor the
  engine's ``take``/``mask``/``where`` could take, so for S > 1 each chunk
  is gathered back explicitly (``all_gather:expand_replicate``).  The
  binding-table columns are thus replicated on every rank, the reference's
  ``P()``.
- **intersect** — each rank probes its own block: one launch of the
  hand-written ``wcoj_intersect`` kernel (K1) with the block's fence index,
  rows it does not own clamped into range with target -2 (never a real
  id); an all-reduce combines the owner-unique hit flags and edge
  positions.
- the **relational tail** — ``join``, ``combine_keys``, ``lexsort`` and
  ``distinct_indices`` first pass their operands through ``_collect``
  (each rank contributes its chunk, an all-gather rebuilds the column; at
  S=1 this is skipped, as the reference skips it), then run the torch
  backend's tail; ``group_reduce`` aggregates distributed: per-rank
  segment partials over its chunk of rows, combined with SUM / MIN / MAX
  all-reduces.

Every collective is recorded in ``exchange_stats`` with the reference's
labels, calls and element counts (the padded pow2 capacities the
collectives move), so a plan's ledger at S=1 equals the reference's.  At
S=1 the all-reduces and reduce-scatters still run and record.

Deadlock discipline: every decision to enter a collective is taken on
replicated values (row counts of replicated columns, totals after their
all-reduce), never on a rank's own chunk.

Groups: on cuda the collectives run over NCCL with rank r on
``cuda:{LOCAL_RANK}``; with ``device="cpu"`` over gloo.  With an
initialised default group the shard count S is the power-of-two floor of
``min(devices or world, world)``; if S < world (or the default group's
backend does not fit the device) the collectives run over a new group of
the first S ranks, and a rank outside it raises ``ValueError`` after
taking part in ``dist.new_group``, as torch requires of every rank.
Without a group the operator set creates a one-rank default group;
``PhysicalSpec.release(store)`` destroys a group the set created.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import torch
import torch.distributed as dist

from repro_torch.core.physical_spec import (CostParams, PhysicalSpec,
                                            register_spec)
from repro_torch.graphdb import torchops
from repro_torch.graphdb.partition import CsrShards, partition_csr
from repro_torch.graphdb.torch_backend import (_AGGREGATES, _I32_MAX,
                                               TorchOperators, _pow2,
                                               _require_device)
from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                    wcoj_intersect)

# minimum pow2 capacity of the collectives' padded operands, the
# reference's ``_MESH_MIN_BUCKET``: the ledgers' element counts agree
_MESH_MIN_BUCKET = 16

_I32 = torch.int32
_I64 = torch.int64


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _pad(t: torch.Tensor, n: int, value) -> torch.Tensor:
    if t.shape[0] >= n:
        return t
    return torch.cat([t, t.new_full((n - t.shape[0],), value)])


# ------------------------------------------------------------ one rank's block

@dataclasses.dataclass
class ShardBlock:
    """Shard ``rank``'s block of one partitioned CSR on the rank's device:
    its local ``indptr`` (``rows_per_shard + 1`` offsets, padded rows
    repeating the last), ``indices`` and ``pos`` zero-padded to the
    partition's ``nnz_cap``, ``edge_base`` (one element: the global flat
    position of the block's first edge) and K1's fence index over
    ``indices``, built at the block's first probe."""
    rank: int
    rows_per_shard: int
    indptr: torch.Tensor
    indices: torch.Tensor
    pos: torch.Tensor | None
    edge_base: torch.Tensor
    index: torch.Tensor | None = None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.indices, self.pos,
                             self.edge_base, self.index) if t is not None)


def upload_block(shards: CsrShards, rank: int, stage) -> ShardBlock:
    """Shard ``rank``'s block of ``shards``, each array put on the device by
    ``stage`` (a host array -> int32 tensor)."""
    return ShardBlock(
        rank=rank, rows_per_shard=shards.rows_per_shard,
        indptr=stage(shards.indptr[rank]),
        indices=stage(shards.indices[rank]),
        pos=stage(shards.pos[rank]) if shards.pos is not None else None,
        edge_base=stage(shards.edge_base[rank:rank + 1]))


def _owned(block: ShardBlock, rows: torch.Tensor):
    """``(mine, local)``: which global rows the block owns (the ownership
    function ``CsrShards.owner_of``: ``row // rows_per_shard``; -1 pads are
    owned by nobody) and each row's local index, clamped into range."""
    rps = block.rows_per_shard
    lr = rows - block.rank * rps
    mine = (rows >= 0) & (lr >= 0) & (lr < rps)
    return mine, lr.clamp(0, rps - 1)


def block_degrees(block: ShardBlock, rows: torch.Tensor) -> torch.Tensor:
    """Degree of every row the block owns, 0 for the others (int32)."""
    mine, lrc = _owned(block, rows)
    d = block.indptr[lrc + 1] - block.indptr[lrc]
    return torch.where(mine, d, 0)


def block_emit(block: ShardBlock, rows: torch.Tensor, deg: torch.Tensor,
               total: int, out_cap: int):
    """The block's share of a row-major expansion into ``out_cap`` slots:
    ``(row_idx, nbr, edge_pos)`` int32, each slot ``j < total`` written
    where the block owns its row and 0 elsewhere, so a SUM over the ranks
    yields the expansion.  ``deg`` is the replicated degree vector."""
    dev = rows.device
    cum = torch.cumsum(deg, 0, dtype=_I64)
    j = torch.arange(out_cap, dtype=_I64, device=dev)
    ic = torch.searchsorted(cum, j, right=True).clamp(max=rows.shape[0] - 1)
    off = j - (cum - deg)[ic]
    mine, lrc = _owned(block, rows[ic])
    mine &= j < total
    flat = (block.indptr[lrc].to(_I64) + off).clamp(
        0, block.indices.shape[0] - 1)
    nbr = block.indices[flat]
    ep = (block.pos[flat] if block.pos is not None
          else block.edge_base + flat.to(_I32))
    return (torch.where(mine, ic.to(_I32), 0), torch.where(mine, nbr, 0),
            torch.where(mine, ep, 0))


def block_probe(block: ShardBlock, rows: torch.Tensor,
                targets: torch.Tensor):
    """The rank-local probe of ``intersect``: is ``targets[i]`` in global
    row ``rows[i]``, for the rows the block owns?  One ``wcoj_intersect``
    launch on the block (the plain version on the CPU): rows it does not
    own are clamped into range and probe target -2, which never matches a
    real id.  Returns ``(hit bool, epos int32)``, ``epos`` the global edge
    position of a hit (through ``pos``, else ``edge_base`` + the local
    slot) and 0 elsewhere; summed over the blocks of a partition they
    equal the probe of the whole CSR."""
    mine, lrc = _owned(block, rows)
    tgt = torch.where(mine, targets, -2).to(_I32).contiguous()
    found, epos = wcoj_intersect(block.indptr, block.indices,
                                 lrc.to(_I32).contiguous(), tgt, block.pos,
                                 block.index)
    if block.pos is None:
        epos = epos + block.edge_base
    hit = mine & found
    return hit, torch.where(hit, epos, 0)


# ---------------------------------------------------------------- operator set

class ShardedOperators(TorchOperators):
    """The torch operator set re-based on a process group (module
    docstring).  Inherits the array primitives, property gathers (with
    the overlay clamp-then-``where``), int32 staging and transfer ledger;
    overrides the pattern operators (collective expansion and probing over
    the rank's blocks) and the relational tail (gathered operands,
    distributed aggregation).  Chains stay on the engine's per-hop loop
    (``supports_chains = False``): each hop is a collective step.  Each
    rank records its own ledgers."""

    name = "sharded"
    supports_chains = False

    def __init__(self, store, devices: int | None = None,
                 device: str | torch.device = "cuda"):
        dev = torch.device(device)
        _require_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        made_world = not dist.is_initialized()
        if made_world:
            # a world of one over an in-process store: no port to pick
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        world, rank = dist.get_world_size(), dist.get_rank()
        want = world if devices is None else max(1, min(int(devices), world))
        n_shards = _pow2_floor(want)
        if n_shards == world and dist.get_backend() == backend:
            group = dist.group.WORLD
        else:
            # every rank of the default group must call new_group
            group = dist.new_group(list(range(n_shards)), backend=backend)
        if rank >= n_shards:
            raise ValueError(
                f"rank {rank} is outside the sharded backend's group of "
                f"{n_shards} shards (world {world}, devices={devices})")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count())))
        super().__init__(store, device=dev)
        self.n_shards = n_shards
        self.rank = rank
        self.group = group
        # the group ``release`` destroys: the default group if this set
        # created it, else a subgroup it made, else none
        self._own_group = (dist.group.WORLD if made_world else
                           None if group is dist.group.WORLD else group)
        # id(csr) -> (weakref(csr), ShardBlock); an entry leaves with its
        # host CSR (base CSRs and delta views alike)
        self._blocks = {}

    def release(self) -> None:
        """Drop this set's device arrays (its blocks and the inherited
        caches) and destroy the process group it created itself, if any.
        The set makes no collective after; ``PhysicalSpec.release`` also
        takes it out of its store's operator cache.  Destroying a default
        group this set created ends it for every other set that joined it."""
        self._blocks.clear()
        self._dev.clear()
        self._cols.clear()
        self._chains.clear()
        if self._own_group is not None and dist.is_initialized():
            dist.destroy_process_group(
                None if self._own_group is dist.group.WORLD
                else self._own_group)
        self._own_group = None

    # ------------------------------------------------------------- plumbing
    def _record_exchange(self, kind: str, label: str, elems: int, n: int = 1):
        for _ in range(n):
            self.exchange_stats.record(kind, label, elems)

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def _reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_empty(t.shape[0] // self.n_shards)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        return out

    def _all_gather(self, chunk: torch.Tensor) -> torch.Tensor:
        out = chunk.new_empty(chunk.shape[0] * self.n_shards)
        dist.all_gather_into_tensor(out, chunk.contiguous(), group=self.group)
        return out

    def _block(self, csr, probe: bool = False) -> ShardBlock:
        """This rank's block of ``csr`` (a base CSR or a delta view's),
        partitioned and uploaded at first use and cached like the torch
        set's ``_csr_dev``: by identity, weakly, with the host object kept
        beside it against address reuse.  The K1 index is built at the
        block's first ``probe``."""
        blk = self._cached(self._blocks, csr)
        if blk is None:
            blk = upload_block(partition_csr(csr, self.n_shards), self.rank,
                               self._stage)
            self._cache_weakly("_blocks", csr, blk)
        if probe and blk.index is None:
            blk.index = build_search_index(blk.indices)
        return blk

    # -------------------------------------------------- collective expansion
    def expand(self, csr, rows_local, max_out=None):
        rows = self._col(rows_local).to(_I32)
        R = rows.shape[0]
        if R == 0:
            return self._z32, self._z32, self._z32
        blk = self._block(csr)
        S = self.n_shards
        fcap = _pow2(R, _MESH_MIN_BUCKET)
        rows_p = _pad(rows, fcap, -1)             # -1: owned by nobody
        deg = self._all_reduce(block_degrees(blk, rows_p))
        self.kernel_stats.record("dispatch", "sharded_deg")
        self._record_exchange("psum", "expand_frontier", fcap)
        # a replicated value: every rank takes the same branch.  torch sums
        # int32 into int64, so the total is exact and the guard reads it
        # directly (the reference guards its int32 sum with a fp32 twin)
        total = int(deg.sum())                     # control-plane sync
        if total > _I32_MAX:
            raise RuntimeError(f"intermediate blow-up: expansion would "
                               f"produce ~{float(total):.3g} rows (beyond "
                               f"the int32 staging envelope)")
        if max_out is not None and total > max_out:
            raise RuntimeError(f"intermediate blow-up: expansion would "
                               f"produce {total} rows > cap {max_out}")
        if total == 0:
            return self._z32, self._z32, self._z32
        out_cap = _pow2(total, max(_MESH_MIN_BUCKET, S))
        parts = block_emit(blk, rows_p, deg, total, out_cap)
        self.kernel_stats.record("dispatch", "sharded_expand")
        chunks = [self._reduce_scatter(p) for p in parts]
        self._record_exchange("psum_scatter", "expand_emit", out_cap, n=3)
        if S > 1:
            chunks = [self._all_gather(c) for c in chunks]
            self._record_exchange("all_gather", "expand_replicate", out_cap,
                                  n=3)
        return tuple(c[:total] for c in chunks)

    # ---------------------------------------------------- collective probing
    def intersect(self, csr, rows_local, targets):
        rows = self._col(rows_local).to(_I32)
        tgt = self._col(targets).to(_I32)
        R = rows.shape[0]
        if R == 0:
            return (torch.zeros(0, dtype=torch.bool, device=self.device),
                    self._z32)
        blk = self._block(csr, probe=True)
        rcap = _pow2(R, _MESH_MIN_BUCKET)
        hit, ep = block_probe(blk, _pad(rows, rcap, -1), _pad(tgt, rcap, -2))
        self.kernel_stats.record("dispatch", "sharded_probe")
        f = self._all_reduce(hit.to(_I32))
        ep = self._all_reduce(ep)
        self._record_exchange("psum", "probe", rcap, n=2)
        found = f[:R] > 0
        return found, torch.where(found, ep[:R], 0)

    # ------------------------------------------------------- tail collectives
    def _collect(self, label: str, arrays: list) -> list:
        """Rebuild each operand column with an explicit (recorded)
        all-gather of the ranks' chunks — the relational tail's exchange
        step.  Skipped at S=1, as the reference skips it."""
        S = self.n_shards
        out = []
        for a in arrays:
            a = self._col(a)
            n = a.shape[0]
            if n == 0 or S == 1:
                out.append(a)
                continue
            padlen = _pow2(n, max(_MESH_MIN_BUCKET, S))
            is_bool = a.dtype == torch.bool
            p = _pad(a.to(torch.uint8) if is_bool else a, padlen, 0)
            c = padlen // S
            g = self._all_gather(p[self.rank * c:(self.rank + 1) * c])
            self.kernel_stats.record("dispatch", "sharded_gather")
            self._record_exchange("all_gather", label, padlen)
            out.append(g[:n].to(torch.bool) if is_bool else g[:n])
        return out

    def join(self, lkeys, rkeys, max_out=None):
        lk, rk = self._collect("join", [lkeys, rkeys])
        return super().join(lk, rk, max_out=max_out)

    def combine_keys(self, cols: list):
        if len(cols) <= 1:
            return super().combine_keys(cols)
        return super().combine_keys(self._collect("combine_keys", cols))

    def lexsort(self, cols: list):
        return super().lexsort(self._collect("order", cols))

    def distinct_indices(self, key):
        return super().distinct_indices(self._collect("distinct", [key])[0])

    # ------------------------------------------- distributed group aggregation
    def group_reduce(self, keys, values):
        """Two-phase distributed aggregation: group ids are resolved once
        on the gathered keys (ascending by key, the single-device sets'
        group order), then every rank reduces its own chunk of the rows
        into per-group partials and the group combines them — SUM for
        SUM / AVG and the group sizes (which COUNT reuses), MIN for MIN
        and each group's first row, MAX for MAX.  The aggregates come out
        as the torch set's: COUNT and SUM int64, AVG float64, MIN / MAX in
        the column's dtype, ``first`` int32."""
        keys = self._col(keys)
        n = keys.shape[0]
        if n == 0:
            return self._z32, {name: self._z32 for name in values}
        bad = [fn for fn, _ in values.values() if fn not in _AGGREGATES]
        if bad:
            raise ValueError(f"unknown aggregate {bad[0]}")
        keys_g = self._collect("group_keys", [keys])[0]
        self.kernel_stats.record("dispatch", "group")
        order, starts = torchops.group_boundaries(keys_g)
        ng = starts.shape[0]
        dev = keys.device
        flags = torch.zeros(n, dtype=_I64, device=dev)
        flags[starts] = 1
        gids = torch.empty(n, dtype=_I64, device=dev)
        gids[order] = torch.cumsum(flags, 0) - 1
        ng_cap = _pow2(ng + 1, _MESH_MIN_BUCKET)
        S = self.n_shards
        npad = _pow2(n, max(_MESH_MIN_BUCKET, S))
        c = npad // S
        lo, hi = self.rank * c, (self.rank + 1) * c
        # pads land in the dummy top group slot (ng_cap - 1 >= ng) and
        # their row index pads high, so no real group's partials see them
        g = _pad(gids, npad, ng_cap - 1)[lo:hi]
        rowidx = _pad(torch.arange(n, dtype=_I64, device=dev), npad,
                      npad)[lo:hi]
        MIN, MAX, SUM = dist.ReduceOp.MIN, dist.ReduceOp.MAX, \
            dist.ReduceOp.SUM
        calls = {"psum": 0, "pmin": 0, "pmax": 0}

        def combine(t, op):
            calls[{SUM: "psum", MIN: "pmin", MAX: "pmax"}[op]] += 1
            return self._all_reduce(t, op)

        def extreme(col, red):
            # the reduction's identity, so a group absent from the chunk
            # leaves the combined value alone
            if col.is_floating_point():
                init = float("inf") if red == "amin" else float("-inf")
            else:
                info = torch.iinfo(col.dtype)
                init = info.max if red == "amin" else info.min
            part = torch.full((ng_cap,), init, dtype=col.dtype, device=dev)
            return part.scatter_reduce_(0, g, col, red, include_self=True)

        cnt = combine(torch.bincount(g, minlength=ng_cap), SUM)
        first = combine(extreme(rowidx, "amin"), MIN)
        names = list(values)
        outs = []
        for nm in names:
            fn, col = values[nm]
            if fn == "COUNT":
                # the group sizes, combined above; the reference reuses
                # them too and records a psum for each COUNT all the same,
                # so the ledger counts one here as well
                outs.append(cnt)
                calls["psum"] += 1
                continue
            col = _pad(self._col(col), npad, 0)[lo:hi]
            if fn in ("SUM", "AVG"):
                acc = torch.float64 if col.is_floating_point() else _I64
                s = combine(torch.zeros(ng_cap, dtype=acc, device=dev)
                            .index_add_(0, g, col.to(acc)), SUM)
                outs.append(s.to(_I64) if fn == "SUM" else
                            s.to(torch.float64)
                            / cnt.clamp(min=1).to(torch.float64))
            else:
                outs.append(combine(extreme(col, "amin" if fn == "MIN"
                                            else "amax"),
                                    MIN if fn == "MIN" else MAX))
        for kind, k in calls.items():
            self._record_exchange(kind, "group_reduce", ng_cap, n=k)
        self.kernel_stats.record("dispatch", "sharded_group")
        return (first[:ng].to(_I32),
                {nm: o[:ng] for nm, o in zip(names, outs)})


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

# The reference's weights (its jax calibration for the local work, and an
# uncalibrated placeholder for alpha_exchange), carried over unchanged: the
# port has fitted none of them, alpha_exchange included, on the H100.
SHARDED_COST = CostParams(alpha_scan=1.0, alpha_expand=5.3,
                          alpha_intersect=34.0, alpha_join=1.0,
                          alpha_exchange=2.0)
_DESCRIPTION = ("row-partitioned CSR blocks, one per rank, with collective "
                "(torch.distributed) expansion and K1 probing, "
                "gather-exchanged tail and all-reduce-combined aggregation; "
                "exchanges recorded in ExchangeStats (DESIGN.md §10)")

SHARDED_SPEC = register_spec(PhysicalSpec(
    name="sharded",
    make_operators=functools.partial(ShardedOperators, device="cuda"),
    cost=SHARDED_COST,
    description=_DESCRIPTION + " (cuda, NCCL)",
))

_SPECS: dict[tuple, PhysicalSpec] = {(None, "cuda"): SHARDED_SPEC}


def sharded_spec(devices: int | None = None,
                 device: str | torch.device | None = None) -> PhysicalSpec:
    """The sharded spec pinned to a shard count and a device
    (``GOpt(store, backend="sharded", devices=2, device="cpu")``).  Each
    pair gets its own registered name — ``sharded`` (every rank, cuda),
    ``sharded[8]``, ``sharded[cpu]``, ``sharded[2,cpu]`` — so plan caches
    and the per-store operator cache never mix shard layouts or devices.
    Raises ``RuntimeError`` for cuda when no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    _require_device(dev)
    devices = None if devices is None else int(devices)
    key = (devices, str(dev))
    spec = _SPECS.get(key)
    if spec is None:
        tags = [str(t) for t in key if t is not None and t != "cuda"]
        spec = register_spec(PhysicalSpec(
            name=f"sharded[{','.join(tags)}]",
            make_operators=functools.partial(ShardedOperators,
                                             devices=devices, device=dev),
            cost=SHARDED_COST,
            description=_DESCRIPTION + (
                f" ({dev}, {'NCCL' if dev.type == 'cuda' else 'gloo'}"
                + (f", pinned to {devices} shards)" if devices else ")"))))
        _SPECS[key] = spec
    return spec
