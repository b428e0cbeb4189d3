"""Binding-table execution engine — the backend-agnostic executor core.

Executes a physical pattern plan (Scan/Expand/ExpandIntersect/Join) followed
by the relational tail of the unified-IR plan.  Intermediate pattern
matchings are dense integer tables whose columns are **backend-native
arrays** (OperatorSet v2, DESIGN.md §7): ``Table`` is a thin wrapper over
backend-owned columns, and every data-parallel step — scan, CSR expansion,
WCOJ membership probes, equi joins, selections, grouped reductions, sorts,
property gathers — goes through the ``OperatorSet`` of the active
``PhysicalSpec`` backend, chosen via ``Engine(store,
backend="torch"|spec)``.  On the torch backend columns are device-resident
``torch.Tensor``s across *all* plan steps; the engine converts to host
exactly once, with ``ops.to_host(table)`` at result delivery, and tags the
backend's ``transfer_stats`` with the current phase
(``pattern`` / ``tail`` / ``deliver``) so the residency invariant — zero
device->host transfers outside delivery — is testable.

The engine also meters the paper's cost-model quantities: rows produced per
operator (communication-cost analogue) and per-operator wall time
(``ExecStats.op_rows`` / ``op_times``; on asynchronously-dispatching
backends the per-operator times are dispatch times — the final sync is
absorbed by delivery).  The times are read off ``ExecStats.spans``: one
span per operator, per step inside one and per phase of a run, stamped on
``span_clock``, the clock ``torch.profiler`` gives its events, so a run's
spans line up with a device trace.  ``ExecStats.host_syncs`` counts the
run's host waits on the device (``TransferStats.sync``).

Modes (used by the RBO ablation benchmarks):
- ``fuse_expand``   — ExpandGetVFusionRule on/off: fused neighbor expansion vs
  EXPAND_EDGE materializing edges then a separate GET_VERTEX gather.
- ``trim_fields``   — FieldTrimRule on/off: lazy property gathers (trimmed) vs
  eagerly materializing every property column of every bound alias at each
  step (what an untrimmed distributed plan ships between workers).
- filters inside pattern vertices/edges (FilterIntoMatchRule) are honored
  during expansion when present.

``run_batch`` executes one plan for many parameter bindings in a single
pattern pass: parameter-dependent predicates are relaxed to the union of
the per-binding masks during the pattern phase (a multi-binding scan
filter), then re-applied exactly per binding before each binding's
relational tail — row-identical to looping ``run`` per binding, but the
expansion/join work is shared.
"""
from __future__ import annotations

import dataclasses
import operator as _op
import time

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.errors import (DeadlineExceeded, ExecError,
                                     ParamError, StaleSnapshotError)
from repro_torch.core.pattern import Pattern, PatternEdge
from repro_torch.core.physical import (ExpandChainNode, ExpandNode, JoinNode,
                                 PlanNode, ScanNode)
from repro_torch.core.physical_spec import (OperatorSet, PhysicalSpec,
                                            TransferStats, get_spec)
from repro_torch.graphdb.chain import (ChainFallback, build_chain_spec,
                                 orientations)
from repro_torch.graphdb.storage import GraphStore

INT_MIN = np.iinfo(np.int64).min

# the spans' clock: ns since the epoch, the clock torch.profiler converts
# its host and device event times to
span_clock = time.time_ns

# tail operators' span names
_STEPS = {ir.Select: "SELECT", ir.Project: "PROJECT", ir.GroupBy: "GROUP",
          ir.OrderBy: "ORDER", ir.Limit: "LIMIT"}

_CMP = {"=": _op.eq, "<>": _op.ne, "<": _op.lt, ">": _op.gt,
        "<=": _op.le, ">=": _op.ge}


def _as_mask(m):
    """Bool mask view of a predicate column: a tensor stays on its device
    (int 0/1 columns compare to nonzero), a host column is cast."""
    if isinstance(m, torch.Tensor):
        return m if m.dtype == torch.bool else m != 0
    return np.asarray(m).astype(bool)


@dataclasses.dataclass
class Table:
    """Binding table: a dict of equally-long backend-native columns.

    ``ops`` is the owning ``OperatorSet``; all row movement (gather, filter,
    concatenation) delegates to it so columns never leave the backend's
    array type.  ``ops=None`` (e.g. ``Table.empty()``) means host numpy
    semantics."""
    cols: dict[str, object]
    nrows: int
    ops: OperatorSet | None = None

    @staticmethod
    def empty() -> "Table":
        return Table({}, 0)

    def take(self, idx) -> "Table":
        if self.ops is None:
            return Table({k: v[idx] for k, v in self.cols.items()},
                         int(idx.shape[0]))
        return Table({k: self.ops.take(v, idx) for k, v in self.cols.items()},
                     int(idx.shape[0]), self.ops)

    def mask(self, m) -> "Table":
        if self.ops is None:
            return Table({k: v[m] for k, v in self.cols.items()},
                         int(m.sum()))
        return self.take(self.ops.nonzero(m))

    def head(self, n: int) -> "Table":
        n = min(int(n), self.nrows)
        return Table({k: v[:n] for k, v in self.cols.items()}, n, self.ops)

    def with_cols(self, new: dict) -> "Table":
        cols = dict(self.cols)
        cols.update(new)
        return Table(cols, self.nrows, self.ops)

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        tables = [t for t in tables if t.nrows > 0]
        if not tables:
            return Table.empty()
        if len(tables) == 1:
            return tables[0]
        ops = tables[0].ops
        keys = tables[0].cols.keys()
        if ops is None:
            cols = {k: np.concatenate([t.cols[k] for t in tables])
                    for k in keys}
        else:
            cols = {k: ops.concat([t.cols[k] for t in tables]) for k in keys}
        return Table(cols, sum(t.nrows for t in tables), ops)


@dataclasses.dataclass
class ExecStats:
    rows_produced: int = 0          # paper's intermediate-result cost
    op_rows: list = dataclasses.field(default_factory=list)
    # (name, start_ns, end_ns, parent) on span_clock: the run's root, its
    # phases, one span per operator (the ``log`` sites, 1:1 with op_rows)
    # and per step inside one; ``parent`` indexes the enclosing span (-1:
    # none)
    spans: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    # host<->device movement summary for this run ({"phase:kind": {...}}),
    # from the backend's TransferStats ledger; "phase:sync" counts syncs
    transfers: dict | None = None
    # compiled-program launch/compile summary ({"kind:label": n}) from the
    # backend's KernelStats ledger — e.g. {"dispatch:fused_chain": 1}
    kernels: dict | None = None
    # device-to-device collective summary ({"kind:label": {...}}) from the
    # backend's ExchangeStats ledger — e.g. {"psum:expand_frontier": ...};
    # None on single-device backends, which never exchange
    exchanges: dict | None = None
    # degraded-path counters ({reason: n}): which fast path this execution
    # fell off and why — e.g. {"stacked_tail_error": 1} when the segmented
    # batch tail fell back to the per-binding loop, {"chain_param": 1} when
    # a fused chain declined a slot value.  Empty on a fully fast-path run.
    fallbacks: dict = dataclasses.field(default_factory=dict)
    # injected-fault summary ({"kind:op": n}) from the backend's FaultStats
    # ledger (graphdb/faults.py); None when no wrapper injected anything
    faults: dict | None = None
    op_spans: list = dataclasses.field(default_factory=list, repr=False)
    _open: int = dataclasses.field(default=-1, repr=False)

    @property
    def op_times(self) -> list:
        """(opname, seconds) aligned 1:1 with op_rows, from the operators'
        spans; on async backends these are dispatch times (the final
        device sync lands in delivery/wall_s) unless the engine ran with
        sync_per_op=True (PROFILE SYNC)."""
        return [(self.spans[i][0],
                 (self.spans[i][2] - self.spans[i][1]) * 1e-9)
                for i in self.op_spans]

    @property
    def host_syncs(self) -> int:
        """The run's host syncs (``TransferStats.sync``), every phase."""
        return TransferStats.host_syncs(self.transfers)

    def open(self, name: str = "", start: int | None = None) -> int:
        """Open a span inside the innermost open one; returns its index."""
        i = len(self.spans)
        self.spans.append((name, span_clock() if start is None else start,
                           0, self._open))
        self._open = i
        return i

    def close(self, i: int, name: str | None = None):
        """Close span ``i`` (the innermost open one), renaming it."""
        old, start, _, parent = self.spans[i]
        self.spans[i] = (old if name is None else name, start, span_clock(),
                         parent)
        self._open = parent

    def end(self, i: int):
        """Close span ``i`` unless ``log`` or ``close`` already did."""
        if self.spans[i][2] == 0:
            self.close(i)

    def log(self, opname: str, rows: int, span: int):
        """Close operator span ``span`` under ``opname``, with its rows."""
        self.close(span, opname)
        self.rows_produced += rows
        self.op_rows.append((opname, rows))
        self.op_spans.append(span)

    def fork(self) -> "ExecStats":
        """A binding's own record, starting from this shared one (the
        batch paths)."""
        return ExecStats(rows_produced=self.rows_produced,
                         op_rows=list(self.op_rows), spans=list(self.spans),
                         fallbacks=dict(self.fallbacks),
                         op_spans=list(self.op_spans))

    def fallback(self, reason: str, n: int = 1):
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n


class Engine:
    def __init__(self, store: GraphStore, fuse_expand: bool = True,
                 trim_fields: bool = True, max_rows: int = 100_000_000,
                 backend: str | PhysicalSpec | OperatorSet = "torch",
                 chain_dispatch: bool = True, sync_per_op: bool = False,
                 snapshot=None, deadline_s: float | None = None):
        self.store = store
        self.fuse_expand = fuse_expand
        self.trim_fields = trim_fields
        self.max_rows = max_rows
        # absolute time.perf_counter() budget: checked cooperatively
        # *between* operators (DESIGN.md §13.4) so an expired request
        # aborts the tail with DeadlineExceeded instead of completing
        # uselessly; None disables the checks
        self.deadline_s = deadline_s
        # chain_dispatch=False keeps ExpandChainNodes on the per-hop loop
        # (the fused path's parity oracle); sync_per_op=True blocks on the
        # device after every operator so op_times are true device times
        # (the PROFILE SYNC mode) instead of dispatch times
        self.chain_dispatch = chain_dispatch
        self.sync_per_op = sync_per_op
        self._params: dict = {}          # execution-time parameter bindings
        self._batch: list[dict] | None = None    # run_batch binding set
        self._deferred: list = []        # union-relaxed predicates to re-apply
        self._tindex = store.triple_index()
        # MVCC-lite: pin a snapshot on mutable stores (delta.py) so this
        # execution sees base ∪ inserts − tombstones as of construction,
        # regardless of concurrent writers
        if snapshot is None:
            snap_fn = getattr(store, "snapshot", None)
            if callable(snap_fn):
                snapshot = snap_fn()
        self.snapshot = snapshot
        self._delta = snapshot is not None and not snapshot.is_empty
        if self._delta and not fuse_expand:
            raise ValueError(
                "fuse_expand=False (the GET_VERTEX ablation) re-resolves "
                "vertex types from base id ranges and is not supported with "
                "a non-empty delta overlay")
        if isinstance(backend, OperatorSet):
            self.ops = backend
        else:
            self.ops = get_spec(backend).operators(store)

    def _table(self, cols: dict, nrows: int) -> Table:
        return Table(cols, nrows, self.ops)

    def _log(self, stats: ExecStats, label: str, tbl: Table | None,
             span: int):
        """Close an operator's span with its output rows; under
        sync_per_op the device finishes the operator's work before the
        clock is read."""
        if self.sync_per_op and tbl is not None and tbl.cols:
            self.ops.block_ready(tbl.cols)
        stats.log(label, tbl.nrows if tbl is not None else 0, span)

    def _offer_bindings(self, bound: list[dict]):
        """Present this execution's parameter bindings to the operator set
        before any work starts.  Plain backends ignore it; fault-injecting
        wrappers (graphdb.faults) use it as the ``bind`` boundary — the one
        place a *binding value* is visible below the engine, which is what
        makes deterministic per-binding poison (and its bisection by the
        serving layer) possible."""
        hook = getattr(self.ops, "binding_boundary", None)
        if hook is not None:
            for b in bound:
                hook(b)

    def _check_deadline(self, label: str):
        """Cooperative deadline check, called between operators — never
        inside one, so compiled dispatches finish atomically."""
        if (self.deadline_s is not None
                and time.perf_counter() > self.deadline_s):
            raise DeadlineExceeded(
                f"deadline_s expired before {label}", operator=label,
                phase=self.ops.transfer_stats.phase or None)

    # ================================================================ pattern
    def _check(self, n, label: str):
        if n > self.max_rows:
            raise RuntimeError(f"intermediate blow-up: {n} rows > cap "
                               f"{self.max_rows} in {label}")

    @staticmethod
    def _annotate_blowup(exc: RuntimeError, label: str):
        if isinstance(exc, ExecError):
            raise exc        # structured failures keep their classification
        raise RuntimeError(f"{exc} in {label}") from None

    def _scan(self, pattern: Pattern, alias: str, stats: ExecStats) -> Table:
        span = stats.open()
        v = pattern.vertices[alias]
        parts = []
        for t in sorted(v.types):
            lo, hi = self.store.type_range(t)
            ids = self.ops.scan(lo, hi)
            if self._delta:
                # snapshot view: drop tombstoned ids, append extension ids
                # (new vertices live above the base id space, per type)
                dead = self.snapshot.dead_for(t)
                if dead is not None:
                    keep = ~self.ops.isin(ids, list(dead))
                    ids = self.ops.take(ids, self.ops.nonzero(keep))
                ext = self.snapshot.ext.get(t)
                if ext is not None:
                    parts.append(ids)
                    parts.append(self.ops.asarray(ext))
                    continue
            parts.append(ids)
        ids = self.ops.concat(parts)
        tbl = self._table({alias: ids}, int(ids.shape[0]))
        tbl = self._apply_fused_predicates(tbl, v.predicates, stats)
        self._log(stats, f"SCAN({alias})", tbl, span)
        self._materialize(tbl, alias, pattern)
        return tbl

    @staticmethod
    def _orientations(e: PatternEdge, from_alias: str):
        """(csr_kind, triple) pairs for expanding ``e`` from ``from_alias``
        — shared with the fused-chain spec builder (``chain.orientations``)
        so both execution paths concatenate identically."""
        return orientations(e, from_alias)

    def _expand_edge(self, tbl: Table, pattern: Pattern, e: PatternEdge,
                     from_alias: str, new_alias: str, stats: ExecStats) -> Table:
        """Primary expansion: bind new_alias (+ edge alias) from from_alias."""
        st = self.store
        label = f"EXPAND(+{new_alias}) via edge '{e.alias}' from '{from_alias}'"
        if tbl.nrows == 0:
            return Table.empty()
        src_ids = tbl.cols[from_alias]
        # the column invariant (scan builds from v.types; expansion only
        # binds type-checked neighbors) lets the type-range membership test
        # resolve *statically* from pattern metadata: a src row is in the
        # keyed type's id range iff its vertex type IS the keyed type —
        # no device mask work unless the alias is genuinely mixed-type
        src_types = pattern.vertices[from_alias].types
        new_types = pattern.vertices[new_alias].types
        snap = self.snapshot if self._delta else None
        outs = []
        for kind, t in self._orientations(e, from_alias):
            keyed_type = t.src if kind == "out" else t.dst
            value_type = t.dst if kind == "out" else t.src
            if value_type not in new_types or keyed_type not in src_types:
                continue
            lo, hi = st.type_range(keyed_type)
            ins_v = dels_v = dead = None
            if snap is not None:
                ins_v = snap.ins.get((t, kind))
                dels_v = snap.dels.get((t, kind))
                dead = snap.dead_for(value_type)
            # extension ids sit above every base type range, so the
            # single-type fast path (whole column assumed in range) is only
            # safe when the snapshot has no extension vertices of this type
            force_mask = snap is not None and keyed_type in snap.ext
            base_ok = True
            local = rows = None
            if len(src_types) == 1 and not force_mask:
                local = src_ids - lo           # fast path: table in range
            else:
                m = (src_ids >= lo) & (src_ids < hi)
                rows = self.ops.nonzero(m)
                if int(rows.shape[0]) == 0:
                    base_ok = False
                else:
                    local = self.ops.take(src_ids, rows) - lo
            if base_ok:
                csr = (st.out_csr if kind == "out" else st.in_csr)[t]
                try:
                    ridx, nbr, epos = self.ops.expand(csr, local,
                                                      max_out=self.max_rows)
                except RuntimeError as exc:
                    self._annotate_blowup(exc, label)
                if (dels_v is not None or dead is not None) \
                        and int(ridx.shape[0]):
                    keep = None
                    if dels_v is not None:
                        # probe the tombstone view: (src, nbr) deleted as of
                        # the snapshot?  Row-key mapping via searchsorted;
                        # misses fail the key-equality check
                        gsrc = self.ops.take(
                            src_ids if rows is None
                            else self.ops.take(src_ids, rows), ridx)
                        kd = self.ops.asarray(dels_v.keys)
                        r = self.ops.searchsorted(kd, gsrc)
                        okr = self.ops.take(kd, r) == gsrc
                        df, _ = self.ops.intersect(dels_v.csr, r, nbr)
                        keep = ~(df & okr)
                    if dead is not None:
                        dm = ~self.ops.isin(nbr, list(dead))
                        keep = dm if keep is None else keep & dm
                    sel = self.ops.nonzero(keep)
                    ridx = self.ops.take(ridx, sel)
                    nbr = self.ops.take(nbr, sel)
                    epos = self.ops.take(epos, sel)
                n_out = int(ridx.shape[0])
                gather = ridx if rows is None else self.ops.take(rows, ridx)
                part = tbl.take(gather).with_cols({
                    new_alias: nbr,
                    f"{e.alias}#t": self.ops.full(n_out, self._tindex[t]),
                    f"{e.alias}#p": epos,
                })
                outs.append(part)
            if ins_v is not None:
                # overlay insert part: map global src ids onto the view's
                # compact rows (keys hold only this triple's keyed type, so
                # the full column probes safely — mismatches compact out)
                ik = self.ops.asarray(ins_v.keys)
                r = self.ops.searchsorted(ik, src_ids)
                okm = self.ops.take(ik, r) == src_ids
                sel = self.ops.nonzero(okm)
                if int(sel.shape[0]):
                    crows = self.ops.take(r, sel)
                    try:
                        ridx2, nbr2, epos2 = self.ops.expand(
                            ins_v.csr, crows, max_out=self.max_rows)
                    except RuntimeError as exc:
                        self._annotate_blowup(exc, label)
                    if dead is not None and int(ridx2.shape[0]):
                        keep2 = self.ops.nonzero(
                            ~self.ops.isin(nbr2, list(dead)))
                        ridx2 = self.ops.take(ridx2, keep2)
                        nbr2 = self.ops.take(nbr2, keep2)
                        epos2 = self.ops.take(epos2, keep2)
                    n2 = int(ridx2.shape[0])
                    part = tbl.take(
                        self.ops.take(sel, ridx2)).with_cols({
                            new_alias: nbr2,
                            f"{e.alias}#t": self.ops.full(
                                n2, self._tindex[t]),
                            f"{e.alias}#p": epos2,
                        })
                    outs.append(part)
        out = Table.concat(outs)
        self._check(out.nrows, label)
        return out

    def _intersect_edge(self, tbl: Table, pattern: Pattern, e: PatternEdge,
                        from_alias: str, cand_alias: str,
                        stats: ExecStats) -> Table:
        """Membership probe: keep rows where edge (from_alias, cand) exists;
        bind the edge. Worst-case-optimal intersection step (a span inside
        its operator's)."""
        st = self.store
        label = (f"INTERSECT({from_alias}-[{e.alias}]-{cand_alias})")
        if tbl.nrows == 0:
            return tbl
        span = stats.open(label)
        outs = []
        src_ids = tbl.cols[from_alias]
        cand = tbl.cols[cand_alias]
        src_types = pattern.vertices[from_alias].types
        cand_types = pattern.vertices[cand_alias].types
        snap = self.snapshot if self._delta else None
        for kind, t in self._orientations(e, from_alias):
            keyed_type = t.src if kind == "out" else t.dst
            value_type = t.dst if kind == "out" else t.src
            if keyed_type not in src_types or value_type not in cand_types:
                continue
            klo, khi = st.type_range(keyed_type)
            vlo, vhi = st.type_range(value_type)
            ins_v = dels_v = None
            force_mask = False
            if snap is not None:
                ins_v = snap.ins.get((t, kind))
                dels_v = snap.dels.get((t, kind))
                force_mask = keyed_type in snap.ext
            csr = (st.out_csr if kind == "out" else st.in_csr)[t]
            if ins_v is not None or dels_v is not None or force_mask:
                # delta path: probe over the full table — base rows out of
                # range clamp to row 0 and mask out, overlay rows (incl.
                # extension srcs) probe the insert view by global key
                inr = ((src_ids >= klo) & (src_ids < khi) &
                       (cand >= vlo) & (cand < vhi))
                local = (src_ids - klo) * inr
                found, epos = self.ops.intersect(csr, local, cand)
                found = found & inr
                if dels_v is not None:
                    kd = self.ops.asarray(dels_v.keys)
                    r = self.ops.searchsorted(kd, src_ids)
                    okr = self.ops.take(kd, r) == src_ids
                    df, _ = self.ops.intersect(dels_v.csr, r, cand)
                    found = found & ~(df & okr)
                if ins_v is not None:
                    ik = self.ops.asarray(ins_v.keys)
                    r2 = self.ops.searchsorted(ik, src_ids)
                    ok2 = self.ops.take(ik, r2) == src_ids
                    f2, p2 = self.ops.intersect(ins_v.csr, r2, cand)
                    f2 = f2 & ok2
                    # mutation-time edge uniqueness means base and overlay
                    # never both match, so the select is exact
                    found = found | f2
                    epos = self.ops.where(f2, p2, epos)
                hit = self.ops.nonzero(found)
                if int(hit.shape[0]) == 0:
                    continue
                part = tbl.take(hit).with_cols({
                    f"{e.alias}#t": self.ops.full(int(hit.shape[0]),
                                                  self._tindex[t]),
                    f"{e.alias}#p": self.ops.take(epos, hit),
                })
                outs.append(part)
                continue
            if len(src_types) == 1 and len(cand_types) == 1:
                rows = None           # statically in range (see _expand_edge)
                local = src_ids - klo
                tgt = cand
            else:
                m = ((src_ids >= klo) & (src_ids < khi) &
                     (cand >= vlo) & (cand < vhi))
                rows = self.ops.nonzero(m)
                if int(rows.shape[0]) == 0:
                    continue
                local = self.ops.take(src_ids, rows) - klo
                tgt = self.ops.take(cand, rows)
            found, epos = self.ops.intersect(csr, local, tgt)
            hit = self.ops.nonzero(found)
            if int(hit.shape[0]) == 0:
                continue
            gather = hit if rows is None else self.ops.take(rows, hit)
            part = tbl.take(gather).with_cols({
                f"{e.alias}#t": self.ops.full(int(hit.shape[0]),
                                              self._tindex[t]),
                f"{e.alias}#p": self.ops.take(epos, hit),
            })
            outs.append(part)
        out = Table.concat(outs)
        self._check(out.nrows, label)
        stats.close(span)
        return out

    def _materialize(self, tbl: Table, alias: str, pattern: Pattern):
        """Untrimmed mode: eagerly attach every property column of ``alias``
        (FieldTrimRule ablation; the shipped-bytes cost the rule removes)."""
        if self.trim_fields or tbl.nrows == 0:
            return
        v = pattern.vertices.get(alias)
        if v is None:
            return
        props = set()
        for t in v.types:
            props |= set(self.store.v_props.get(t, {}))
        for p in sorted(props):
            tbl.cols[f"__mat.{alias}.{p}"] = self.ops.vertex_prop(
                tbl.cols[alias], p)

    def _apply_fused_predicates(self, tbl: Table, preds: list,
                                stats: ExecStats) -> Table:
        for p in preds or []:
            if tbl.nrows == 0:
                break
            span = stats.open("FILTER")
            if self._batch is not None and ir.expr_params(p):
                # batched execution: relax to the union of the per-binding
                # masks (a stacked multi-binding filter); the exact
                # per-binding predicate re-applies before each tail
                self._deferred.append(p)
                m = self._union_mask(tbl, p)
            else:
                m = _as_mask(self._eval(tbl, p))
            tbl = tbl.mask(m)
            stats.close(span)
        return tbl

    def _union_mask(self, tbl: Table, pred):
        saved = self._params
        m = None
        try:
            for b in self._batch:
                self._params = b
                mb = _as_mask(self._eval(tbl, pred))
                m = mb if m is None else (m | mb)
        finally:
            self._params = saved
        return m

    def exec_pattern(self, pattern: Pattern, node: PlanNode,
                     stats: ExecStats) -> Table:
        self._check_deadline(type(node).__name__)
        if isinstance(node, ScanNode):
            return self._scan(pattern, node.alias, stats)
        if isinstance(node, ExpandNode):
            tbl = self.exec_pattern(pattern, node.child, stats)
            span = stats.open()
            edges = list(node.edges)
            # primary expansion via the first edge
            e0 = edges[0]
            frm = e0.other(node.new_alias)
            if self.fuse_expand:
                tbl = self._expand_edge(tbl, pattern, e0, frm,
                                        node.new_alias, stats)
            else:
                # EXPAND_EDGE then a separate GET_VERTEX pass: endpoint ids
                # are re-resolved from the edge bindings and re-type-checked
                # (the work ExpandGetVFusionRule eliminates)
                tbl = self._expand_edge(tbl, pattern, e0, frm,
                                        node.new_alias, stats)
                if tbl.nrows:
                    nbr = tbl.cols[node.new_alias]
                    types = self.store._sorted_types()
                    bounds = np.array(
                        [self.store.v_offset[t] for t in types]
                        + [self.store.n_vertices], dtype=np.int64)
                    tidx = self.ops.searchsorted(          # extra pass
                        self.ops.asarray(bounds), nbr, side="right") - 1
                    allowed = np.zeros(len(types), dtype=bool)
                    for i, t in enumerate(types):
                        allowed[i] = t in pattern.vertices[
                            node.new_alias].types
                    tbl = tbl.mask(self.ops.take(self.ops.asarray(allowed),
                                                 tidx))
                self._log(stats, f"GET_VERTEX({node.new_alias})", tbl,
                          span)
                span = stats.open()
            # intersect the remaining edges (WCOJ step)
            for e in edges[1:]:
                frm = e.other(node.new_alias)
                tbl = self._intersect_edge(tbl, pattern, e, frm,
                                           node.new_alias, stats)
            v = pattern.vertices[node.new_alias]
            tbl = self._apply_fused_predicates(tbl, v.predicates, stats)
            for e in edges:
                tbl = self._apply_fused_predicates(tbl, e.predicates, stats)
            self._log(stats, f"EXPAND(+{node.new_alias}|{len(edges)}e)", tbl,
                      span)
            self._materialize(tbl, node.new_alias, pattern)
            return tbl
        if isinstance(node, ExpandChainNode):
            if not self.fuse_expand:
                # ExpandGetVFusion ablation: run the pre-fusion plan
                return self.exec_pattern(pattern, node.unfused(), stats)
            tbl = self.exec_pattern(pattern, node.child, stats)
            return self._exec_chain(pattern, node, tbl, stats)
        if isinstance(node, JoinNode):
            lt = self.exec_pattern(pattern, node.left, stats)
            rt = self.exec_pattern(pattern, node.right, stats)
            return self._exec_join(pattern, node, lt, rt, stats)
        raise TypeError(node)

    # ================================================================= chains
    def _chain_spec(self, node: ExpandChainNode, pattern: Pattern):
        """ChainSpec for the fused dispatch, memoized on the plan node per
        (store, backend) — plans are shared through the prepared-plan cache,
        so one compiled chain serves every engine over the same store."""
        key = (id(self.store), getattr(self.store, "compaction_epoch", 0),
               self.ops.name)
        cached = node.__dict__.get("_chain_spec")
        if cached is None or cached[0] != key:
            spec = build_chain_spec(self.store, self._tindex, pattern, node)
            node.__dict__["_chain_spec"] = cached = (key, spec)
        return cached[1]

    def _chain_slot_values(self, spec):
        """Evaluate the spec's runtime slots against the current parameter
        bindings.  Raises ``ChainFallback`` for values the int32-staged
        fused program cannot honor (non-integers, out-of-envelope scalars);
        the per-hop loop then executes with full host semantics."""
        i32lo, i32hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        scalars, value_lists = [], []
        for kind, lhs, rhs in spec.slots:
            if kind == "scalar":
                v = (self._param_value(rhs.name) if isinstance(rhs, ir.Param)
                     else rhs.value)
                v = self._encode_scalar(lhs, v)
                if (isinstance(v, bool) or not isinstance(v, (int, np.integer))
                        or not i32lo < int(v) <= i32hi):
                    raise ChainFallback(repr(v))
                scalars.append(int(v))
            else:
                values = (self._param_value(rhs.name)
                          if isinstance(rhs, ir.Param) else rhs)
                enc = []
                for x in values:
                    xv = self._encode_scalar(lhs, x)
                    if isinstance(xv, bool) or not isinstance(
                            xv, (int, np.integer)):
                        raise ChainFallback(repr(xv))
                    if i32lo < int(xv) <= i32hi:   # out-of-envelope: no match
                        enc.append(int(xv))
                value_lists.append(enc)
        return scalars, value_lists

    def _exec_chain(self, pattern: Pattern, node: ExpandChainNode,
                    tbl: Table, stats: ExecStats) -> Table:
        """Fused chain execution: ONE backend dispatch through
        ``ops.chain_program`` when the backend advertises it and the shape
        is in the fusable envelope; otherwise (and on the first, measuring
        execution of a shape) the thin-frontier per-hop loop — the parity
        oracle the fused program is held to."""
        span = stats.open()
        first = node.steps[0].from_alias
        hops = "".join(f"+{s.alias}" for s in node.steps)
        label = f"EXPANDCHAIN({hops})"
        prog = None
        delta_decline = False
        if self._delta:
            triples = [t for s in node.steps for ee in s.all_edges()
                       for t in ee.triples]
            delta_decline = self.snapshot.affects_chain(triples)
        if (self.chain_dispatch and tbl.nrows and delta_decline
                and getattr(self.ops, "supports_chains", False)):
            stats.fallback("chain_delta")
        if (self.chain_dispatch and tbl.nrows and not delta_decline
                and getattr(self.ops, "supports_chains", False)):
            spec = self._chain_spec(node, pattern)
            # batched runs relax parameter predicates to per-binding unions;
            # the fused program bakes exact slot values, so those chains
            # stay on the loop (which defers them correctly)
            if spec is not None and not (self._batch is not None
                                         and spec.has_params):
                prog = self.ops.chain_program(spec)
        if prog is not None and prog.ready():
            try:
                res = prog.run(tbl.cols[first], tbl.nrows,
                               *self._chain_slot_values(spec), self.max_rows)
                if res is None:
                    stats.fallback("chain_capacity")
            except ChainFallback:
                stats.fallback("chain_param")
                res = None
            except RuntimeError as exc:
                self._annotate_blowup(exc, label)
            if res is not None:
                rows, cols, n = res
                out = tbl.take(rows).with_cols(cols) if n else Table.empty()
                self._log(stats, label, out, span)
                for s in node.steps:
                    self._materialize(out, s.alias, pattern)
                return out
        # per-hop loop: thin frontier (source column, hop columns, a
        # provenance row index), full table gathered once at the end
        cur = self._table({first: tbl.cols[first],
                           "__chain_row": self.ops.arange(tbl.nrows)},
                          tbl.nrows)
        sizes = []
        for s in node.steps:
            self._check_deadline(f"hop(+{s.alias})")
            if cur.nrows == 0:
                sizes.append(0)
                continue
            cur = self._expand_edge(cur, pattern, s.edge, s.from_alias,
                                    s.alias, stats)
            sizes.append(cur.nrows)     # pre-filter total = fused capacity
            for e in s.intersect_edges:
                cur = self._intersect_edge(cur, pattern, e,
                                           e.other(s.alias), s.alias, stats)
            v = pattern.vertices[s.alias]
            cur = self._apply_fused_predicates(cur, v.predicates, stats)
            for e in s.all_edges():
                cur = self._apply_fused_predicates(cur, e.predicates, stats)
        if prog is not None:
            prog.observe(sizes)         # fix/regrow the capacity schedule
        if cur.nrows == 0:
            self._log(stats, label, None, span)
            return Table.empty()
        rows = cur.cols.pop("__chain_row")
        del cur.cols[first]          # tbl carries the original column
        out = tbl.take(rows).with_cols(cur.cols)
        self._log(stats, label, out, span)
        for s in node.steps:
            self._materialize(out, s.alias, pattern)
        return out

    def _exec_join(self, pattern: Pattern, node: JoinNode, lt: Table,
                   rt: Table, stats: ExecStats) -> Table:
        span = stats.open()
        # join on the shared vertex aliases plus any other column both
        # sides bound (shared edges must bind identically on both sides)
        keys = sorted(set(node.keys) |
                      (set(lt.cols) & set(rt.cols) - {"__pad"}))
        keys = [k for k in keys if not k.startswith("__mat.")]
        label = f"JOIN({'/'.join(keys) or 'cross'})"
        lkey, rkey = self._pack_join_keys(lt, rt, keys)
        try:
            lidx, ridx = self.ops.join(lkey, rkey, max_out=self.max_rows)
        except RuntimeError as exc:
            self._annotate_blowup(exc, label)
        self._check(int(lidx.shape[0]), label)
        cols = {k: self.ops.take(v, lidx) for k, v in lt.cols.items()}
        for k, v in rt.cols.items():
            if k not in cols:
                cols[k] = self.ops.take(v, ridx)
        out = self._table(cols, int(lidx.shape[0]))
        self._log(stats, f"JOIN({'/'.join(keys)})", out, span)
        return out

    def _pack_join_keys(self, lt: Table, rt: Table, keys: list[str]):
        """Pack the join columns of both sides into one comparable key
        column each.  The columns are factorized *jointly* (over the
        concatenation) so equal tuples get equal keys across the two
        tables; ``ops.combine_keys`` guarantees ascending key order is the
        tuples' lexicographic order, which fixes the sort-merge output
        order identically on every backend."""
        if not keys:
            return (self.ops.full(lt.nrows, 0), self.ops.full(rt.nrows, 0))
        both = self.ops.combine_keys(
            [self.ops.concat([lt.cols[k], rt.cols[k]]) for k in keys])
        return both[:lt.nrows], both[lt.nrows:]

    # ============================================================ expressions
    def _param_value(self, name: str):
        try:
            return self._params[name]
        except KeyError:
            raise ParamError("unbound parameter at evaluation", missing=[name],
                             declared=self._params) from None

    def _full(self, n: int, value):
        if isinstance(value, str):      # host-only fallback (string literals)
            return np.full(n, value)
        return self.ops.full(n, value)

    def _eval(self, tbl: Table, e):
        st = self.store
        if isinstance(e, ir.Lit):
            return self._full(tbl.nrows, e.value)
        if isinstance(e, ir.Param):
            return self._full(tbl.nrows, self._param_value(e.name))
        if isinstance(e, ir.Var):
            return tbl.cols[e.alias]
        if isinstance(e, ir.Prop):
            mat = tbl.cols.get(f"__mat.{e.alias}.{e.name}")
            if mat is not None:
                return mat
            if f"{e.alias}#t" in tbl.cols:   # edge alias
                return self.ops.edge_prop(tbl.cols[f"{e.alias}#t"],
                                          tbl.cols[f"{e.alias}#p"], e.name)
            return self.ops.vertex_prop(tbl.cols[e.alias], e.name)
        if isinstance(e, ir.Cmp):
            lhs, rhs = e.lhs, e.rhs
            l = self._eval(tbl, lhs)
            r = self._encode_rhs(lhs, rhs, tbl)
            return _CMP[e.op](l, r)
        if isinstance(e, ir.InSet):
            item = self._eval(tbl, e.item)
            values = (self._param_value(e.values.name)
                      if isinstance(e.values, ir.Param) else e.values)
            vals = [self._encode_scalar(e.item, v) for v in values]
            return self.ops.isin(item, vals)
        if isinstance(e, ir.BoolOp):
            if e.op == "NOT":
                return ~_as_mask(self._eval(tbl, e.args[0]))
            acc = _as_mask(self._eval(tbl, e.args[0]))
            for a in e.args[1:]:
                if e.op == "AND":
                    acc = acc & _as_mask(self._eval(tbl, a))
                else:
                    acc = acc | _as_mask(self._eval(tbl, a))
            return acc
        raise TypeError(f"cannot evaluate {e!r}")

    def _encode_scalar(self, lhs, value):
        if isinstance(value, str):
            if isinstance(lhs, ir.Prop):
                return self.store.encode_str(lhs.name, value)
            return -1
        return value

    def _encode_rhs(self, lhs, rhs, tbl):
        if isinstance(rhs, ir.Lit):
            return self._encode_scalar(lhs, rhs.value)
        if isinstance(rhs, ir.Param):
            return self._encode_scalar(lhs, self._param_value(rhs.name))
        return self._eval(tbl, rhs)

    # ============================================================= relational
    def bind_params(self, plan: ir.LogicalPlan,
                    params: dict | None = None) -> dict:
        """Resolve execution-time bindings against the plan's declared
        parameter set.  Build-time bindings (``plan.params``) act as
        defaults; ``params`` overrides them.  Raises ``ParamError`` on a
        binding that names no declared parameter, or on a referenced
        parameter left unbound."""
        referenced = plan.referenced_params()
        declared = referenced | set(plan.params)
        provided = dict(params or {})
        extra = set(provided) - declared
        if extra:
            raise ParamError("binding names no declared parameter",
                             extra=extra, declared=declared)
        # structural params (hop counts baked into the pattern shape, as
        # recorded by GraphIrBuilder) cannot be rebound: silently accepting
        # a different value would lie about what executes.  Other build-time
        # bindings that no expression references are simply unused and may
        # be re-supplied freely (shared bindings dicts across queries).
        structural = plan.hints.get("structural_params") or {}
        rebound = {k for k, v in provided.items()
                   if k in structural and structural[k] != v}
        if rebound:
            raise ParamError(
                "structural parameter(s) were bound at build time and "
                "cannot be rebound at execution — re-prepare instead",
                extra=rebound, declared=declared)
        effective = {**plan.params, **provided}
        missing = referenced - set(effective)
        if missing:
            raise ParamError("unbound parameter(s)", missing=missing,
                             declared=declared)
        return effective

    def _plan_head(self, plan: ir.LogicalPlan, pattern_plan):
        from repro_torch.core.physical import default_left_deep_plan
        if self.snapshot is not None and getattr(self.snapshot, "retired",
                                                 False):
            raise StaleSnapshotError(
                f"snapshot v{self.snapshot.version} was retired by "
                "compaction; pin a fresh snapshot")
        ops = list(plan.ops)
        if not isinstance(ops[0], ir.MatchPattern):
            raise ValueError("plan must start with MATCH_PATTERN")
        pattern = ops[0].pattern
        return ops, pattern, pattern_plan or default_left_deep_plan(pattern)

    def run(self, plan: ir.LogicalPlan, pattern_plan: PlanNode | None = None,
            params: dict | None = None, stats: ExecStats | None = None,
            setup: int | None = None):
        """Execute a logical plan; returns (result Table, ExecStats).
        ``params`` binds the plan's late-bound ``ir.Param`` nodes.  The
        returned table is host-resident: the engine converts the
        backend-native binding table with ``ops.to_host`` exactly once,
        here at delivery — never between plan steps.

        ``stats`` is the caller's record when it has opened spans of its
        own (``GOpt.run``), ``setup`` its open ``engine.setup`` span; the
        engine records ``engine.setup`` (binding, marks), ``pattern``,
        ``tail`` and ``deliver`` inside the innermost open span, or
        inside a root ``engine.run`` of a record of its own."""
        ts = self.ops.transfer_stats
        root = None
        if stats is None:
            stats = ExecStats()
            root = stats.open("engine.run")
        if setup is None:
            setup = stats.open("engine.setup")
        self._params = self.bind_params(plan, params)
        self._offer_bindings([self._params])
        t0 = time.perf_counter()
        ops, pattern, node = self._plan_head(plan, pattern_plan)
        ledgers = (ts, self.ops.kernel_stats, self.ops.exchange_stats,
                   self.ops.fault_stats)
        marks = [ld.hold() for ld in ledgers]
        try:
            stats.close(setup)
            phase = self._phase(stats, "pattern")
            tbl = self.exec_pattern(pattern, node, stats)
            phase = self._phase(stats, "tail", phase)
            for op in ops[1:]:
                tbl = self._run_relational(tbl, op, stats)
            phase = self._phase(stats, "deliver", phase)
            tbl = self.ops.to_host(tbl)
            stats.close(phase)
            stats.wall_s = time.perf_counter() - t0
            stats.transfers = ts.summary(marks[0])
            stats.kernels = ledgers[1].summary(marks[1])
            stats.exchanges = ledgers[2].summary(marks[2]) or None
            stats.faults = ledgers[3].summary(marks[3]) or None
        finally:
            ts.set_phase("")
            for ld, m in zip(ledgers, marks):
                ld.release(m)
        if root is not None:
            stats.close(root)
        return tbl, stats

    def _phase(self, stats: ExecStats, phase: str,
               prev: int | None = None) -> int:
        """Enter ``phase``: close the previous phase's span, open this
        one's and tag the transfer ledger."""
        if prev is not None:
            stats.close(prev)
        self.ops.transfer_stats.set_phase(phase)
        return stats.open(phase)

    def run_batch(self, plan: ir.LogicalPlan,
                  pattern_plan: PlanNode | None = None,
                  bindings: list[dict | None] = ()):
        """One pattern pass, many parameter bindings (the vectorized
        ``PreparedQuery.execute_many`` path).  Parameter-dependent pattern
        predicates execute as the union of the per-binding filters, the
        exact predicate re-applies per binding, and the relational tails
        run **stacked**: a ``__seg`` binding-id column turns the per-binding
        group/order/limit/distinct loops into one segmented pass (falling
        back to the per-binding loop on any RuntimeError or when a tail
        operator is outside the segmented envelope) — results are
        row-identical to looping ``run``.  Returns
        ``[(host Table, ExecStats), ...]``."""
        bound = [self.bind_params(plan, b) for b in bindings]
        if not bound:
            return []
        self._offer_bindings(bound)
        ops, pattern, node = self._plan_head(plan, pattern_plan)
        ts = self.ops.transfer_stats
        ledgers = (ts, self.ops.kernel_stats, self.ops.exchange_stats,
                   self.ops.fault_stats)
        marks = [ld.hold() for ld in ledgers]
        try:
            return self._run_batch(ops, pattern, node, bound, marks)
        finally:
            for ld, m in zip(ledgers, marks):
                ld.release(m)

    def _run_batch(self, ops, pattern, node, bound, marks):
        ts = self.ops.transfer_stats
        mark, kmark, emark, fmark = marks
        shared = ExecStats()
        t0 = time.perf_counter()
        self._batch = bound
        self._deferred = []
        self._params = {}
        ts.set_phase("pattern")
        try:
            tbl = self.exec_pattern(pattern, node, shared)
        finally:
            self._batch = None
            ts.set_phase("")
        pattern_s = time.perf_counter() - t0
        # the shared pattern phase's transfers belong to every binding; the
        # per-binding window starts fresh so binding i never reads binding
        # i-1's tail/deliver events
        pattern_transfers = ts.summary(mark)
        pattern_kernels = self.ops.kernel_stats.summary(kmark)
        pattern_exchanges = self.ops.exchange_stats.summary(emark)
        deferred, self._deferred = self._deferred, []
        env = (ops, tbl, bound, deferred, shared, pattern_s,
               pattern_transfers, pattern_kernels, pattern_exchanges)
        reason = None
        results = None
        if len(bound) > 1:
            if self._tail_stackable(ops[1:]):
                try:
                    results = self._run_tails_stacked(*env)
                except ExecError:
                    # structured failures (deadline aborts, injected faults)
                    # belong to the containment layer, not the loop fallback
                    raise
                except RuntimeError:
                    # fall back to the binding loop
                    reason = "stacked_tail_error"
            else:
                reason = "tail_unstackable"
        if results is None:
            results = self._run_tails_loop(*env, reason=reason)
        # the batch shares one execution, so any injected-fault window
        # describes the batch and is attributed to every binding (like the
        # shared pattern phase's kernels/transfers)
        fsum = self.ops.fault_stats.summary(fmark)
        if fsum:
            for _, st in results:
                st.faults = dict(fsum)
        return results

    @staticmethod
    def _tail_stackable(rel_ops) -> bool:
        """Tail operators the segmented (``__seg``-stacked) pass supports:
        parameter-free expressions only (parameters would need per-segment
        values), no string-literal outputs (host-only columns cannot ride
        the backend's segment ops), and no global aggregate downstream of a
        row-reducing operator (its empty-input COUNT()=0 fix-up is
        per-binding)."""
        exprs: list = []
        reducing = False
        for op in rel_ops:
            if isinstance(op, ir.Select):
                exprs.append(op.predicate)
                reducing = True
            elif isinstance(op, ir.Project):
                exprs.extend(e for e, _ in op.items)
            elif isinstance(op, ir.GroupBy):
                if not op.keys and reducing:
                    return False
                exprs.extend(e for e, _ in op.keys)
                exprs.extend(a.arg for a, _ in op.aggs if a.arg is not None)
            elif isinstance(op, ir.OrderBy):
                exprs.extend(e for e, _ in op.items)
                reducing = reducing or op.limit is not None
            elif isinstance(op, ir.Limit):
                reducing = True
            else:
                return False
        return not any(ir.expr_params(e)
                       or (isinstance(e, ir.Lit) and isinstance(e.value, str))
                       for e in exprs)

    def _refilter(self, tbl: Table, deferred, b: dict) -> Table:
        """Exact per-binding re-application of the union-relaxed pattern
        predicates."""
        self._params = b
        if not deferred or tbl.nrows == 0:
            return tbl
        m = None
        for p in deferred:
            mp = _as_mask(self._eval(tbl, p))
            m = mp if m is None else (m & mp)
        return tbl.mask(m)

    def _run_tails_loop(self, ops, tbl, bound, deferred, shared, pattern_s,
                        pattern_transfers, pattern_kernels,
                        pattern_exchanges, reason=None):
        """The per-binding tail loop — the stacked path's fallback and
        parity oracle.  ``reason`` (when the stacked pass was skipped or
        failed) is recorded in each binding's ``ExecStats.fallbacks``."""
        ts = self.ops.transfer_stats
        ks = self.ops.kernel_stats
        es = self.ops.exchange_stats
        results = []
        for b in bound:
            bind_mark = ts.mark()
            kbind = ks.mark()
            ebind = es.mark()
            tb0 = time.perf_counter()
            st = shared.fork()
            span = st.open()
            if reason is not None:
                st.fallback(reason)
            ts.set_phase("tail")
            try:
                t = self._refilter(tbl, deferred, b)
                st.log("BATCH_BIND", t.nrows, span)
                for op in ops[1:]:
                    t = self._run_relational(t, op, st)
                ts.set_phase("deliver")
                t = self.ops.to_host(t)
            finally:
                ts.set_phase("")
            st.wall_s = pattern_s + (time.perf_counter() - tb0)
            st.transfers = {k: dict(v) for k, v in pattern_transfers.items()}
            for k, v in ts.summary(bind_mark).items():
                ent = st.transfers.setdefault(k, {"calls": 0, "elems": 0})
                ent["calls"] += v["calls"]
                ent["elems"] += v["elems"]
            st.kernels = dict(pattern_kernels)
            for k, v in ks.summary(kbind).items():
                st.kernels[k] = st.kernels.get(k, 0) + v
            exch = {k: dict(v) for k, v in pattern_exchanges.items()}
            for k, v in es.summary(ebind).items():
                ent = exch.setdefault(k, {"calls": 0, "elems": 0})
                ent["calls"] += v["calls"]
                ent["elems"] += v["elems"]
            st.exchanges = exch or None
            results.append((t, st))
        return results

    def _run_tails_stacked(self, ops, tbl, bound, deferred, shared,
                           pattern_s, pattern_transfers, pattern_kernels,
                           pattern_exchanges):
        """One segmented tail for the whole binding batch: per-binding rows
        are stacked with a ``__seg`` binding-id column, every relational
        operator runs once over the stack (grouping keys on (seg, key);
        order/limit per segment), and the stack crosses to the host in ONE
        delivery before splitting per binding.  Like the shared pattern
        phase, the stacked tail's wall time / op rows / kernel and transfer
        windows are shared work and attributed to every binding's
        ``ExecStats`` — they describe the batch, not one binding's slice."""
        ts = self.ops.transfer_stats
        ks = self.ops.kernel_stats
        es = self.ops.exchange_stats
        bind_mark = ts.mark()
        kbind = ks.mark()
        ebind = es.mark()
        tb0 = time.perf_counter()
        st = shared.fork()
        span = st.open()
        ts.set_phase("tail")
        try:
            parts, counts = [], []
            for i, b in enumerate(bound):
                t = self._refilter(tbl, deferred, b)
                counts.append(t.nrows)
                if t.nrows:
                    parts.append(t.with_cols(
                        {"__seg": self.ops.full(t.nrows, i)}))
            if not parts:
                raise RuntimeError("stacked tail: all bindings empty")
            self._params = {}
            stacked = Table.concat(parts)
            st.log("BATCH_BIND", stacked.nrows, span)
            for op in ops[1:]:
                stacked = self._run_relational_seg(stacked, op, len(bound),
                                                   st)
            ts.set_phase("deliver")
            host = self.ops.to_host(stacked)
        finally:
            ts.set_phase("")
        tail_s = time.perf_counter() - tb0
        seg = np.asarray(host.cols.pop("__seg"))
        window = ts.summary(bind_mark)
        kwindow = ks.summary(kbind)
        ewindow = es.summary(ebind)
        results = []
        for i, c in enumerate(counts):
            if c == 0:
                # empty bindings keep the loop path's host-side semantics
                # (e.g. the COUNT()-over-empty fix-up) at zero device cost
                t = Table.empty()
                bst = shared.fork()
                bst.log("BATCH_BIND", 0, bst.open())
                for op in ops[1:]:
                    t = self._run_relational(t, op, bst)
                if t.ops is not None:
                    t = self.ops.to_host(t)
            else:
                m = seg == i
                t = Table({k: v[m] for k, v in host.cols.items()},
                          int(m.sum()))
                bst = st.fork()
            bst.wall_s = pattern_s + tail_s
            bst.transfers = {k: dict(v) for k, v in
                             pattern_transfers.items()}
            for k, v in window.items():
                ent = bst.transfers.setdefault(k, {"calls": 0, "elems": 0})
                ent["calls"] += v["calls"]
                ent["elems"] += v["elems"]
            bst.kernels = dict(pattern_kernels)
            for k, v in kwindow.items():
                bst.kernels[k] = bst.kernels.get(k, 0) + v
            exch = {k: dict(v) for k, v in pattern_exchanges.items()}
            for k, v in ewindow.items():
                ent = exch.setdefault(k, {"calls": 0, "elems": 0})
                ent["calls"] += v["calls"]
                ent["elems"] += v["elems"]
            bst.exchanges = exch or None
            results.append((t, bst))
        return results

    def _seg_head_mask(self, seg, nrows: int, k: int, limit: int):
        """Boolean mask keeping each segment's first ``limit`` rows of a
        segment-major table."""
        starts = self.ops.searchsorted(seg, self.ops.arange(k))
        pos = self.ops.arange(nrows) - self.ops.take(starts, seg)
        return pos < limit

    def _run_relational_seg(self, tbl: Table, op, k: int,
                            stats: ExecStats) -> Table:
        """Segment-aware twin of ``_run_relational``: one pass over the
        ``__seg``-stacked batch table, row-identical per segment to running
        the plain operator on that segment alone.  The stack is segment-
        major throughout (every operator preserves or re-establishes it)."""
        self._check_deadline(type(op).__name__)
        span = stats.open(_STEPS.get(type(op), ""))
        out = self._relational_seg(tbl, op, k, stats, span)
        stats.end(span)
        return out

    def _relational_seg(self, tbl: Table, op, k: int, stats: ExecStats,
                        span: int) -> Table:
        seg = tbl.cols["__seg"]
        if isinstance(op, ir.Select):
            if tbl.nrows:
                tbl = tbl.mask(_as_mask(self._eval(tbl, op.predicate)))
            self._log(stats, "SELECT", tbl, span)
            return tbl
        if isinstance(op, ir.Project):
            cols = {name: (self._eval(tbl, e) if tbl.nrows
                           else self.ops.full(0, 0))
                    for e, name in op.items}
            cols["__seg"] = seg
            out = self._table(cols, tbl.nrows)
            if op.distinct and out.nrows:
                key = self.ops.combine_keys(list(out.cols.values()))
                out = out.take(self.ops.distinct_indices(key))
            self._log(stats, "PROJECT", out, span)
            return out
        if isinstance(op, ir.GroupBy):
            if tbl.nrows == 0:   # empty-input fix-ups are per-binding
                raise RuntimeError("stacked tail: stack emptied")
            kcols = [self._eval(tbl, e) for e, _ in op.keys]
            key = self.ops.combine_keys([seg] + kcols)
            vals = {}
            for a, name in op.aggs:
                col = (self._eval(tbl, a.arg) if a.arg is not None
                       else self.ops.full(tbl.nrows, 0))
                vals[name] = (a.fn, col)
            first, aggd = self.ops.group_reduce(key, vals)
            cols = {name: self.ops.take(kc, first)
                    for (e, name), kc in zip(op.keys, kcols)}
            cols.update(aggd)
            cols["__seg"] = self.ops.take(seg, first)
            out = self._table(cols, int(first.shape[0]))
            self._log(stats, "GROUP", out, span)
            return out
        if isinstance(op, ir.OrderBy):
            if tbl.nrows == 0:
                return tbl
            sort_cols = []
            for e, asc in reversed(op.items):
                name = None
                if isinstance(e, ir.Var) and e.alias in tbl.cols:
                    name = e.alias
                col = tbl.cols[name] if name else self._eval_output(tbl, e)
                sort_cols.append(col if asc else -col)
            sort_cols.append(seg)            # last column = primary key
            order = self.ops.lexsort(sort_cols)
            out = tbl.take(order)
            if op.limit is not None:
                out = out.mask(self._seg_head_mask(out.cols["__seg"],
                                                   out.nrows, k, op.limit))
            return out
        if isinstance(op, ir.Limit):
            if tbl.nrows == 0:
                return tbl
            return tbl.mask(self._seg_head_mask(seg, tbl.nrows, k, op.n))
        raise RuntimeError(f"stacked tail: unsupported operator {op!r}")

    def _run_relational(self, tbl: Table, op, stats: ExecStats) -> Table:
        """One tail operator in its span (closed by ``log`` where the
        operator is logged; ORDER and LIMIT are not)."""
        self._check_deadline(type(op).__name__)
        span = stats.open(_STEPS.get(type(op), ""))
        out = self._relational(tbl, op, stats, span)
        stats.end(span)
        return out

    def _relational(self, tbl: Table, op, stats: ExecStats,
                    span: int) -> Table:
        if isinstance(op, ir.Select):
            if tbl.nrows:
                tbl = tbl.mask(_as_mask(self._eval(tbl, op.predicate)))
            self._log(stats, "SELECT", tbl, span)
            return tbl
        if isinstance(op, ir.Project):
            cols = {name: (self._eval(tbl, e) if tbl.nrows
                           else self.ops.full(0, 0))
                    for e, name in op.items}
            out = self._table(cols, tbl.nrows)
            if op.distinct and out.nrows:
                key = self.ops.combine_keys(list(out.cols.values()))
                out = out.take(self.ops.distinct_indices(key))
            self._log(stats, "PROJECT", out, span)
            return out
        if isinstance(op, ir.GroupBy):
            if tbl.nrows == 0:
                # built by the operator set, so the columns stay its own
                # array type through the rest of the tail
                cols = {n: self.ops.full(0, 0) for _, n in op.keys}
                for a, n in op.aggs:
                    # global aggregate over empty input: COUNT()==0
                    if not op.keys and a.fn == "COUNT":
                        return self._table({n: self.ops.full(1, 0)}, 1)
                    cols[n] = self.ops.full(0, 0)
                return self._table(cols, 0)
            kcols = [self._eval(tbl, e) for e, _ in op.keys]
            key = (self.ops.combine_keys(kcols) if kcols
                   else self.ops.full(tbl.nrows, 0))
            vals = {}
            for a, name in op.aggs:
                col = (self._eval(tbl, a.arg) if a.arg is not None
                       else self.ops.full(tbl.nrows, 0))
                vals[name] = (a.fn, col)
            first, aggd = self.ops.group_reduce(key, vals)
            cols = {name: self.ops.take(kc, first)
                    for (e, name), kc in zip(op.keys, kcols)}
            cols.update(aggd)
            out = self._table(cols, int(first.shape[0]))
            self._log(stats, "GROUP", out, span)
            return out
        if isinstance(op, ir.OrderBy):
            if tbl.nrows == 0:
                return tbl
            sort_cols = []
            for e, asc in reversed(op.items):
                name = None
                if isinstance(e, ir.Var) and e.alias in tbl.cols:
                    name = e.alias
                col = tbl.cols[name] if name else self._eval_output(tbl, e)
                sort_cols.append(col if asc else -col)
            order = self.ops.lexsort(sort_cols)
            if op.limit is not None:
                order = order[:op.limit]
            return tbl.take(order)
        if isinstance(op, ir.Limit):
            return tbl.head(op.n)
        raise TypeError(op)

    def _eval_output(self, tbl: Table, e):
        """Evaluate an ORDER BY expression against output column names first
        (aggregate outputs), else as a normal expression."""
        name = repr(e)
        if name in tbl.cols:
            return tbl.cols[name]
        if isinstance(e, ir.Agg):
            raise ValueError(f"ORDER BY references aggregate {name} "
                             "not present in RETURN")
        return self._eval(tbl, e)
