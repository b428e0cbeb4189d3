"""PhysicalSpec — the pluggable backend layer (paper §5.3, DESIGN.md §2/§7).

The paper's modularity claim at the physical level: a graph system plugs into
GOpt by *registering* (a) implementations of the physical operators the CBO
emits (scan, expand, expand-and-intersect/WCOJ, pattern join, and the
relational tail primitives) and (b) the cost-model parameters the optimizer
uses to weigh those operators. The optimizer and the binding-table executor
core are backend-agnostic; everything data-parallel goes through an
``OperatorSet`` resolved from the registry.

OperatorSet v2 (DESIGN.md §7): operators take and return **backend-native
arrays**.  The engine's binding ``Table`` is a thin wrapper over
backend-owned columns; the only sanctioned device->host conversion is
``ops.to_host(...)``, which the engine calls exactly once per query — at
result delivery, never between plan steps.  Besides the six core operators
(``REQUIRED_OPERATORS``) a backend inherits host-numpy defaults for the
generic array primitives (``ARRAY_PRIMITIVES``); a device backend overrides
them so binding tables stay resident.  ``TransferStats`` is the
instrumentation hook proving residency: backends record every host<->device
data movement, tagged with the engine's current execution phase.

Two backends ship in this package (lazily imported on first ``get_spec``):

- ``torch`` — device-resident ``torch.Tensor`` columns (int32 ids, bool
  masks), eager PyTorch primitives (``graphdb/torchops.py``), the
  hand-written CUDA ``wcoj_intersect`` kernel for membership probes, and a
  sort-merge / sorted-run relational tail.  One spec per device:
  ``torch`` on cuda, ``torch[cpu]`` on the host (``torch_spec(device)``).
- ``numpy`` — the host path over ``repro_torch.graphdb.vecops``: the
  tests' host oracle and the last rung of the serving layer's degradation
  ladder.  A ``QueryServer`` over a device spec has no host rung unless
  its caller passes ``fallback_spec`` explicitly.

Adding another backend: subclass ``OperatorSet``, build a ``PhysicalSpec``
with a ``make_operators`` factory and a ``CostParams``, call
``register_spec``, and hold the operator set to
``validate_operator_set(ops, conformance=True)`` — the v2 conformance
suite checks semantics *and* the row-order contract against tiny oracles.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import numpy as np
import torch

# operator names every backend must implement itself (callable attributes on
# the OperatorSet it returns from make_operators, not inherited from the base)
REQUIRED_OPERATORS = ("scan", "expand", "intersect", "join",
                      "combine_keys", "group_reduce")

# v2 array primitives: host-numpy defaults on the base class; a backend with
# its own array type overrides all of them (plus vertex_prop/edge_prop) so
# binding-table columns never leave the device between plan steps
ARRAY_PRIMITIVES = ("asarray", "to_host", "take", "mask", "concat", "nonzero",
                    "full", "arange", "isin", "searchsorted", "lexsort",
                    "distinct_indices", "where")

@dataclasses.dataclass(frozen=True)
class CostParams:
    """Per-operator cost weights consumed by ``GraphOptimizer`` (Eq. 2/3).

    ``alpha_scan`` scales the Scan leaf cost F(v); ``alpha_expand`` the
    first-edge expansion term F(p_s)*sigma; ``alpha_intersect`` the extra
    WCOJ membership probes of an expand-and-intersect; ``alpha_join`` the
    binary pattern-join term F(p_s1)+F(p_s2).  ``alpha_exchange`` is the
    distributed backends' per-hop communication term: every expansion /
    probe moves its frontier across the device mesh before any local work,
    so its cost gains ``alpha_exchange * F(p_s)`` (and a join pays it on
    both input sides) — a CBO on a sharded backend thereby trades
    communication volume against intersection work.  Single-device
    backends leave it 0.0."""
    alpha_scan: float = 1.0
    alpha_expand: float = 1.0
    alpha_intersect: float = 1.0
    alpha_join: float = 1.0
    alpha_exchange: float = 0.0


class _Ledger:
    """The event list the four ledgers share, bounded.

    ``mark()`` is a plain read: the number of events recorded since
    construction or ``reset``, the ``since`` a later ``count`` /
    ``summary`` passes.  ``hold()`` takes a mark that keeps its events
    until ``release(mark)``; once no hold is open, ``release`` drops all
    but the newest ``KEEP`` events when more than ``2 * KEEP`` are kept.
    The engine holds its marks for a run and releases them when it has
    taken its summaries, so an operator set serving queries for hours
    keeps O(``KEEP``) events, not its history, and a plain mark still
    reads its events while fewer than ``KEEP`` come after it.  Reading
    from a mark whose events were dropped raises.  Not thread-safe: the
    engines sharing an operator set run one at a time (the QueryServer
    runs every wave on one worker thread)."""

    KEEP = 1 << 14

    def __init__(self):
        self.events: list[tuple] = []
        self._base = 0                # events dropped before events[0]
        self._held: list[int] = []    # holds not yet released

    def reset(self):
        self.events.clear()
        self._base = 0
        self._held.clear()

    def mark(self) -> int:
        return self._base + len(self.events)

    def hold(self) -> int:
        self._held.append(self.mark())
        return self._held[-1]

    def release(self, mark: int):
        if mark in self._held:        # a reset drops every hold
            self._held.remove(mark)
        if not self._held and len(self.events) > 2 * self.KEEP:
            drop = len(self.events) - self.KEEP
            del self.events[:drop]
            self._base += drop

    def _since(self, since: int) -> list[tuple]:
        if since < self._base:
            raise ValueError(f"events since mark {since} were dropped "
                             f"(kept from {self._base}); hold() the mark")
        return self.events[since - self._base:]


class TransferStats(_Ledger):
    """Host<->device data-movement ledger of one ``OperatorSet``.

    Backends call ``record("d2h"|"h2d", n_elems)`` on every array that
    crosses the boundary; the engine tags the current execution phase
    (``"pattern"`` / ``"tail"`` / ``"deliver"``) so tests and benchmarks can
    assert the residency invariant: zero ``d2h`` outside ``deliver``.

    ``sync()`` records one ``sync`` event wherever the host waits for the
    device's stream: a value read back (a row count, a blow-up guard's
    total, a chain's control vector, a ``nonzero``'s size), each column
    delivered, each staging copy from pageable host memory, a
    ``block_ready`` barrier.  The torch set counts them at the call site
    on every device, so a CPU run of a plan counts what the card's run
    does."""

    def __init__(self):
        super().__init__()
        self.phase = ""
        # events: (phase, kind, elems)

    def record(self, kind: str, elems: int):
        self.events.append((self.phase, kind, int(elems)))

    def sync(self):
        self.events.append((self.phase, "sync", 0))

    def set_phase(self, phase: str):
        self.phase = phase

    def reset(self):
        super().reset()
        self.phase = ""

    def count(self, kind: str, phase: str | None = None,
              since: int = 0) -> int:
        return sum(1 for ph, k, _ in self._since(since)
                   if k == kind and (phase is None or ph == phase))

    def elems(self, kind: str, phase: str | None = None,
              since: int = 0) -> int:
        return sum(n for ph, k, n in self._since(since)
                   if k == kind and (phase is None or ph == phase))

    def summary(self, since: int = 0) -> dict[str, dict[str, int]]:
        """``{"phase:kind": {"calls": n, "elems": m}}`` over events recorded
        after the ``mark()`` value ``since`` (``"pattern:sync"``: the host
        syncs of the pattern phase)."""
        out: dict[str, dict[str, int]] = {}
        for ph, k, n in self._since(since):
            ent = out.setdefault(f"{ph or 'unphased'}:{k}",
                                 {"calls": 0, "elems": 0})
            ent["calls"] += 1
            ent["elems"] += n
        return out

    @staticmethod
    def mid_plan_d2h(transfers: dict | None) -> int:
        """Device->host transfer calls outside the delivery phase, from a
        ``summary()`` dict (``ExecStats.transfers``) — THE residency
        invariant: zero for a conforming device-resident execution.  Lives
        here because this class owns the summary key format."""
        return sum(v["calls"] for k, v in (transfers or {}).items()
                   if k.endswith(":d2h") and not k.startswith("deliver:"))

    @staticmethod
    def host_syncs(transfers: dict | None) -> int:
        """Host syncs in a ``summary()`` dict, every phase."""
        return sum(v["calls"] for k, v in (transfers or {}).items()
                   if k.endswith(":sync"))


class KernelStats(_Ledger):
    """Compiled-program launch/compile ledger — ``TransferStats``' sibling.

    Backends record one ``dispatch`` event per *compiled program launch*
    (jit'd compound primitives, Pallas kernels, fused chain programs) and
    one ``compile`` event per program they newly build; cheap eager glue
    (takes, masks, pads, slices) is deliberately not recorded.  The engine
    snapshots the ledger into ``ExecStats.kernels`` per run, so tests and
    benchmarks can assert dispatch counts — e.g. that a fused 3-hop chain
    executes as exactly one ``fused_chain`` dispatch (DESIGN.md §8)."""

    # events: (kind, label, n)

    def record(self, kind: str, label: str, n: int = 1):
        self.events.append((kind, label, int(n)))

    def count(self, kind: str, label: str | None = None,
              since: int = 0) -> int:
        return sum(n for k, lb, n in self._since(since)
                   if k == kind and (label is None or lb == label))

    def summary(self, since: int = 0) -> dict[str, int]:
        out: dict[str, int] = {}
        for k, lb, n in self._since(since):
            out[f"{k}:{lb}"] = out.get(f"{k}:{lb}", 0) + n
        return out


class ExchangeStats(_Ledger):
    """Cross-device collective ledger — the third sibling of
    ``TransferStats`` / ``KernelStats``, owned by distributed backends.

    A sharded backend records one event per collective it dispatches
    (``kind`` in ``all_gather`` / ``psum`` / ``psum_scatter`` /
    ``ppermute`` / ``all_to_all``) with the operator label and the number
    of elements moved per device.  Collectives are *device-to-device* —
    they never appear in ``TransferStats`` — so the pair of ledgers proves
    the distributed residency contract: frontiers are exchanged across the
    mesh on device (``ExchangeStats`` non-empty) while host transfers stay
    confined to the delivery gather (``TransferStats.mid_plan_d2h == 0``).
    The engine snapshots the ledger into ``ExecStats.exchanges`` per run;
    single-device backends simply never record and the summary stays
    empty."""

    # events: (kind, label, elems)

    def record(self, kind: str, label: str, elems: int):
        self.events.append((kind, label, int(elems)))

    def count(self, kind: str | None = None, label: str | None = None,
              since: int = 0) -> int:
        return sum(1 for k, lb, _ in self._since(since)
                   if (kind is None or k == kind)
                   and (label is None or lb == label))

    def elems(self, kind: str | None = None, label: str | None = None,
              since: int = 0) -> int:
        return sum(n for k, lb, n in self._since(since)
                   if (kind is None or k == kind)
                   and (label is None or lb == label))

    def summary(self, since: int = 0) -> dict[str, dict[str, int]]:
        """``{"kind:label": {"calls": n, "elems": m}}`` over events recorded
        after the ``mark()`` value ``since``."""
        out: dict[str, dict[str, int]] = {}
        for k, lb, n in self._since(since):
            ent = out.setdefault(f"{k}:{lb}", {"calls": 0, "elems": 0})
            ent["calls"] += 1
            ent["elems"] += n
        return out


class FaultStats(_Ledger):
    """Injected-fault ledger — the fourth sibling of ``TransferStats`` /
    ``KernelStats`` / ``ExchangeStats``, owned by fault-wrapped operator
    sets (``graphdb/faults.py``, DESIGN.md §13).

    A ``FaultPlan`` wrapper records one event per injection it performs
    (``kind`` in ``transient`` / ``permanent`` / ``capacity`` /
    ``latency``) with the operator boundary it fired at.  Clean backends
    never record and the summary stays empty, so the serving layer's
    failure accounting can always read the ledger unconditionally."""

    # events: (kind, op, n)

    def record(self, kind: str, op: str, n: int = 1):
        self.events.append((kind, op, int(n)))

    def count(self, kind: str | None = None, op: str | None = None,
              since: int = 0) -> int:
        return sum(n for k, o, n in self._since(since)
                   if (kind is None or k == kind) and (op is None or o == op))

    def summary(self, since: int = 0) -> dict[str, int]:
        out: dict[str, int] = {}
        for k, o, n in self._since(since):
            out[f"{k}:{o}"] = out.get(f"{k}:{o}", 0) + n
        return out


class OperatorSet:
    """Physical operator implementations bound to one ``GraphStore``.

    v2 contract: every array argument and result is **backend-native** —
    whatever array type the backend keeps its binding-table columns in.
    ``asarray`` brings host data in, ``to_host`` (the only sanctioned
    device->host conversion) brings results out.  The base class ships
    working host-numpy implementations of the generic array primitives and
    the property gathers, so a host backend only implements
    ``REQUIRED_OPERATORS``; a device backend overrides the primitives too.

    Output **row order is part of the contract** (DESIGN.md §2.2): operators
    are order-preserving (row-major over inputs; joins emit pairs in
    sort-merge order; groups in ascending key order) so any two conforming
    backends produce row-for-row identical binding tables for one plan.
    ``validate_operator_set(ops, conformance=True)`` checks both semantics
    and order against tiny oracles.
    """

    name = "abstract"
    # True on backends that implement chain_program (fused whole-chain
    # execution, DESIGN.md §8); the engine checks this before building specs
    supports_chains = False
    # True on backends that trace/compile programs keyed by input shapes —
    # consumers that can stabilize shapes (e.g. the QueryServer padding a
    # wave's binding list to its pow2 bucket) should do so only here
    compiled = False
    # dtype the set stages id/position columns in (the device sets pin
    # torch.int32); None accepts any integer dtype
    index_dtype = None
    # False on sets whose arrays live on an accelerator: the QueryServer
    # offers its host rung (``fallback_spec``) by default only when True
    on_host = True

    def __init__(self, store):
        self.store = store
        self.transfer_stats = TransferStats()
        self.kernel_stats = KernelStats()
        self.exchange_stats = ExchangeStats()
        self.fault_stats = FaultStats()

    def reset_ledgers(self):
        """Clear the instrumentation ledgers.  Operator sets are shared
        per (store, backend), so a consumer that reads without its own
        ``mark()`` reads a neighbor's events; the QueryServer scopes the
        ledgers to one wave by resetting here between waves and reading
        from a mark taken after it (DESIGN.md §9)."""
        self.transfer_stats.reset()
        self.kernel_stats.reset()
        self.exchange_stats.reset()
        self.fault_stats.reset()

    # ------------------------------------------------- array primitives (v2)
    def asarray(self, values):
        """Host values -> backend array (records ``h2d`` on device sets)."""
        return np.asarray(values)

    def to_host(self, x):
        """Backend array (or a binding ``Table`` of them) -> host numpy.

        The engine calls this exactly once per query, at result delivery;
        device backends record the ``d2h`` transfer."""
        if hasattr(x, "cols") and hasattr(x, "nrows"):      # binding Table
            return type(x)({k: self._array_to_host(v)
                            for k, v in x.cols.items()}, x.nrows)
        return self._array_to_host(x)

    def _array_to_host(self, a) -> np.ndarray:
        return np.asarray(a)

    def take(self, a, idx):
        return a[idx]

    def mask(self, a, m):
        return a[m]

    def concat(self, parts: list):
        if not parts:
            return np.zeros(0, dtype=np.int64)
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts)

    def nonzero(self, m):
        return np.nonzero(m)[0]

    def full(self, n: int, value):
        return np.full(n, value)

    def arange(self, n: int):
        return np.arange(n, dtype=np.int64)

    def isin(self, a, values) -> np.ndarray:
        return np.isin(a, np.asarray(list(values), dtype=np.int64))

    def searchsorted(self, sorted_arr, values, side: str = "left"):
        return np.searchsorted(sorted_arr, values, side=side)

    def lexsort(self, cols: list):
        """Indices sorting rows by ``cols`` (last col primary, stable)."""
        return np.lexsort(tuple(cols))

    def distinct_indices(self, key):
        """First-occurrence row index per distinct key value, ascending —
        ``take``-ing them preserves the original order of first sightings."""
        _, first = np.unique(key, return_index=True)
        return np.sort(first)

    def where(self, cond, a, b):
        """Elementwise select: ``a`` where ``cond`` else ``b`` (the delta
        overlay's epos merge between base and overlay probe results)."""
        return np.where(cond, a, b)

    # ------------------------------------------------------ property gathers
    def vertex_prop(self, ids, prop: str):
        """Property column gather for (possibly mixed-type) vertex ids;
        missing -> the backend's integer-min sentinel."""
        return self.store.vertex_prop(ids, prop)

    def edge_prop(self, triple_ids, pos, prop: str):
        return self.store.edge_prop(triple_ids, pos, prop)

    # ------------------------------------------------------------- pattern
    def scan(self, lo: int, hi: int):
        """All vertex ids of one type range ``[lo, hi)`` (SCAN leaf)."""
        raise NotImplementedError

    def expand(self, csr, rows_local, max_out: int | None = None):
        """Expand each row's vertex (local id into ``csr``) to all neighbors.

        Returns ``(row_idx, neighbor_global_id, edge_pos)`` in row-major
        order: originating binding-table row, neighbor id, and the edge's
        identity position (``csr.pos``-mapped when present)."""
        raise NotImplementedError

    def intersect(self, csr, rows_local, targets):
        """WCOJ membership probe: is ``targets[i]`` in row ``rows_local[i]``?

        Returns ``(found: bool[n], edge_pos: int[n])`` — ``edge_pos`` is
        the edge identity position, valid only where ``found``."""
        raise NotImplementedError

    def join(self, lkeys, rkeys, max_out: int | None = None):
        """Equi join of two key columns -> (lidx, ridx) row pairs in
        sort-merge order (stable by left sorted position, then right)."""
        raise NotImplementedError

    # ---------------------------------------------------- relational tail
    def combine_keys(self, cols: list):
        """Pack multiple key columns into one comparable key column whose
        ascending order is the lexicographic order of the tuples
        (``cols[0]`` most significant)."""
        raise NotImplementedError

    def group_reduce(self, keys, values: dict):
        """Group by key; groups ascend by key value.  Returns
        ``(first_row_index_per_group, {name: aggregated})``."""
        raise NotImplementedError

    # ------------------------------------------------- optional capabilities
    def chain_program(self, spec):
        """Fused whole-chain execution (DESIGN.md §8): given a
        ``graphdb.chain.ChainSpec``, return a program handle with
        ``ready() -> bool``, ``observe(hop_sizes)`` (capacity feedback from
        a per-hop measuring run) and ``run(src_col, nrows, scalars,
        value_lists, max_rows) -> (rows, cols, n) | None`` — ``None`` means
        "fall back to the per-hop loop for this execution" (capacity
        overflow; the handle regrows its buckets).  ``run`` must be
        row-identical to the per-hop loop.  The base returns ``None``: no
        fused-chain capability."""
        return None

    def pin_chain(self, spec, pinned: bool = True) -> bool:
        """Protect (or release) the compiled program handle of one chain
        shape from backend-side cache eviction — the QueryServer pins the
        chains of its hottest plans so a burst of cold plans cannot evict
        a hot plan's warmed programs.  Returns True when a handle was
        (un)pinned; the base has no program cache and returns False."""
        return False

    def block_ready(self, arrays):
        """Synchronization barrier for the sync-per-op PROFILE mode: block
        until every array in ``arrays`` (any pytree) is computed.  Host
        backends are synchronous — the default is a no-op."""
        return arrays


@dataclasses.dataclass(frozen=True)
class PhysicalSpec:
    """One backend's registration: operator factory + cost model + optional
    post-CBO physical rewrites.

    ``physical_rules`` is the backend's hook into the optimizer pipeline
    (DESIGN.md §6.2): each entry is a callable ``(plan_node, ctx) ->
    PlanNode | None`` run by the ``post_physical`` pipeline phase after the
    CBO has fixed the join/expansion order.  A rule returns a rewritten
    plan (or None / the input to decline).  Rewrites must be
    semantics-preserving — they repackage the plan for the backend (e.g.
    expand-chain fusion), never change its results."""
    name: str
    make_operators: Callable[..., OperatorSet]   # GraphStore -> OperatorSet
    cost: CostParams = CostParams()
    description: str = ""
    physical_rules: tuple = ()

    def operators(self, store) -> OperatorSet:
        """Operator set for ``store``, cached on the store so device-array
        uploads survive across per-query ``Engine`` instances."""
        cache = store.__dict__.setdefault("_physical_ops_cache", {})
        ops = cache.get(self.name)
        if ops is None:
            ops = self.make_operators(store)
            validate_operator_set(ops)
            cache[self.name] = ops
        return ops

    def release(self, store) -> None:
        """Take ``store``'s cached operator set for this spec out of the
        cache and let it free what it holds (its ``release``, where it has
        one: the sharded set's blocks and the process group it created)."""
        ops = store.__dict__.get("_physical_ops_cache", {}).pop(self.name,
                                                                None)
        if hasattr(ops, "release"):
            ops.release()


_REGISTRY: dict[str, PhysicalSpec] = {}

# built-in backends, imported on first lookup (registration is a module
# side effect) so importing the engine never builds an operator set
_LAZY_BACKENDS = {
    "torch": "repro_torch.graphdb.torch_backend",
    "numpy": "repro_torch.graphdb.numpy_backend",
    "sharded": "repro_torch.graphdb.sharded_backend",
}


def register_spec(spec: PhysicalSpec, overwrite: bool = False) -> PhysicalSpec:
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(backend: str | PhysicalSpec) -> PhysicalSpec:
    """Resolve a backend name (or pass a spec through)."""
    if isinstance(backend, PhysicalSpec):
        return backend
    if backend not in _REGISTRY and backend in _LAZY_BACKENDS:
        importlib.import_module(_LAZY_BACKENDS[backend])
    if backend not in _REGISTRY:
        raise KeyError(f"unknown physical backend {backend!r}; "
                       f"available: {available_backends()}")
    return _REGISTRY[backend]


def available_backends() -> list[str]:
    return sorted(set(_REGISTRY) | set(_LAZY_BACKENDS))


def validate_operator_set(ops: OperatorSet,
                          conformance: bool = False) -> OperatorSet:
    """Interface check (always) + the OperatorSet-v2 conformance suite
    (``conformance=True``): run every operator against tiny oracles,
    checking values *and* the row-order contract.  Raises ``TypeError``
    with the full failure list, so a third backend gets every broken
    operator in one shot."""
    missing = [n for n in REQUIRED_OPERATORS
               if not callable(getattr(ops, n, None))
               or getattr(type(ops), n, None) is getattr(OperatorSet, n)]
    if missing:
        raise TypeError(f"operator set {type(ops).__name__} does not "
                        f"implement required operators: {missing}")
    absent = [n for n in ARRAY_PRIMITIVES
              if not callable(getattr(ops, n, None))]
    if absent:
        raise TypeError(f"operator set {type(ops).__name__} lost array "
                        f"primitives: {absent}")
    if conformance:
        failures = run_operator_conformance(ops)
        if failures:
            raise TypeError(
                f"operator set {type(ops).__name__} failed OperatorSet-v2 "
                f"conformance ({len(failures)}):\n  " + "\n  ".join(failures))
    return ops


# --------------------------------------------------------------------------
# OperatorSet v2 conformance suite
# --------------------------------------------------------------------------

def _conf_csr():
    """Tiny sorted-CSR fixture: 4 rows -> [10,12] / [3,7,9] / [] / [12]."""
    from repro_torch.graphdb.storage import CSR
    return CSR(indptr=np.array([0, 2, 5, 5, 6], dtype=np.int64),
               indices=np.array([10, 12, 3, 7, 9, 12], dtype=np.int64))


def _conf_csr2():
    """Second-hop fixture keyed over ids 0..12 (the value range of
    ``_conf_csr``): 3->[5], 7->[2,4], 10->[1], 12->[0,8], rest empty."""
    from repro_torch.graphdb.storage import CSR
    return CSR(indptr=np.array([0, 0, 0, 0, 1, 1, 1, 1, 3, 3, 3, 4, 4, 6],
                               dtype=np.int64),
               indices=np.array([5, 2, 4, 1, 0, 8], dtype=np.int64))


def _conformance_chain(ops, fails: list[str]):
    """Fused-chain contract: a 2-hop chain over the tiny fixtures must be
    row-identical to the hand-computed per-hop expansion — provenance rows,
    bound aliases, and edge identity columns alike."""
    from repro_torch.graphdb.chain import ChainSpec, HopSpec, OrientSpec
    spec = ChainSpec("a", [
        HopSpec("a", "b", "e1", [OrientSpec("out", _conf_csr(), 0, 4, 0)],
                [], None),
        HopSpec("b", "c", "e2", [OrientSpec("out", _conf_csr2(), 0, 13, 1)],
                [], None),
    ], [])
    prog = ops.chain_program(spec)
    if prog is None:
        fails.append("chain_program: supports_chains backend returned None")
        return
    prog.observe([6, 8])
    res = prog.run(ops.asarray(np.array([1, 0, 3], dtype=np.int64)), 3,
                   [], [], max_rows=1 << 20)
    if res is None:
        fails.append("chain_program.run: refused after observe()")
        return
    rows, cols, n = res
    H = ops.to_host
    oracle = {
        "rows": [0, 0, 0, 1, 1, 1, 2, 2],
        "b": [3, 7, 7, 10, 12, 12, 12, 12],
        "c": [5, 2, 4, 1, 0, 8, 0, 8],
        "e2#p": [0, 1, 2, 3, 4, 5, 4, 5],
        "e1#p": [2, 3, 3, 0, 1, 1, 5, 5],
        "e1#t": [0] * 8, "e2#t": [1] * 8,
    }
    got = {"rows": np.asarray(H(rows))[:n]}
    for k in ("b", "c", "e1#t", "e1#p", "e2#t", "e2#p"):
        if k not in cols:
            fails.append(f"chain_program: missing output column {k!r}")
            return
        # device-side dtype pin: device sets stage id/identity columns as
        # int32; checking after to_host would be blind (it widens to int64
        # by design)
        if ops.index_dtype is not None:
            dt = getattr(cols[k], "dtype", None)
            if dt != ops.index_dtype:
                fails.append(f"chain_program.{k}: device column dtype "
                             f"{dt}, want {ops.index_dtype} (staging "
                             f"contract)")
        got[k] = np.asarray(H(cols[k]))[:n]
    if n != 8:
        fails.append(f"chain_program: got {n} rows, want 8")
        return
    for k, want in oracle.items():
        if not np.array_equal(got[k].astype(np.int64), np.asarray(want)):
            fails.append(f"chain_program.{k}: got {got[k].tolist()!r}, "
                         f"want {want!r}")


def dtype_contract_failures(ops: OperatorSet) -> list[str]:
    """Dtype contract at operator boundaries (DESIGN.md §12), checked on
    the *backend-native* output arrays — ``to_host`` deliberately widens
    int32 to int64 and would mask a staging-dtype mixup.

    Every backend: ``isin`` and ``intersect.found`` emit a real bool mask
    (callers compose masks with ``~``/``&``; bitwise-not on an int 0/1
    column corrupts silently — the PR-8 regression), and id/position
    columns out of ``scan``/``arange``/``expand``/``intersect``/``nonzero``
    are integer-kind.  A set that declares an ``index_dtype`` (the torch
    sets: ``torch.int32``) additionally pins those columns to it."""
    fails: list[str] = []
    staged = ops.index_dtype

    def is_int(dt):
        if isinstance(dt, torch.dtype):
            return not (dt.is_floating_point or dt.is_complex
                        or dt == torch.bool)
        return getattr(dt, "kind", "?") in ("i", "u")

    def is_bool(dt):
        return dt == torch.bool or (not isinstance(dt, torch.dtype)
                                    and dt == np.bool_)

    def want_mask(name, a):
        if not is_bool(getattr(a, "dtype", None)):
            fails.append(f"{name}: mask dtype {getattr(a, 'dtype', None)}, "
                         f"want bool")

    def want_int(name, a):
        if not is_int(getattr(a, "dtype", None)):
            fails.append(f"{name}: dtype {getattr(a, 'dtype', None)}, "
                         f"want integer kind")
        elif staged is not None and a.dtype != staged:
            fails.append(f"{name}: device dtype {a.dtype}, want {staged} "
                         f"(staging contract)")

    try:
        A = ops.asarray
        want_mask("isin", ops.isin(A(np.array([5, 1, 3], np.int64)), [1, 5]))
        want_int("scan", ops.scan(0, 4))
        want_int("arange", ops.arange(4))
        want_int("nonzero",
                 ops.nonzero(A(np.array([False, True, True]))))
        csr = _conf_csr()
        # device backends cache uploaded CSR twins by id(csr): keep the
        # fixture alive on the ops instance so its id is never recycled by
        # a real CSR that would then alias the stale cache entry
        ops.__dict__.setdefault("_conf_fixtures", []).append(csr)
        ridx, nbr, epos = ops.expand(csr, A(np.array([0, 1], np.int64)))
        want_int("expand.row_idx", ridx)
        want_int("expand.nbr", nbr)
        want_int("expand.edge_pos", epos)
        found, ipos = ops.intersect(csr, A(np.array([0, 1], np.int64)),
                                    A(np.array([12, 8], np.int64)))
        want_mask("intersect.found", found)
        want_int("intersect.edge_pos", ipos)
    except Exception as exc:                           # noqa: BLE001
        fails.append(f"dtype contract aborted: {type(exc).__name__}: {exc}")
    return fails


def run_operator_conformance(ops: OperatorSet) -> list[str]:
    """Exercise every v2 operator against hand-computed oracles; returns a
    list of human-readable failures (empty = conformant).  Uses only
    synthetic arrays + a tiny CSR, so any backend can run it without a
    populated ``GraphStore``."""
    fails: list[str] = []
    H = ops.to_host
    A = ops.asarray

    def check(name, got, want, order_matters=True):
        got = np.asarray(H(got))
        want = np.asarray(want)
        if not order_matters:
            got, want = np.sort(got), np.sort(want)
        if got.shape != want.shape or not np.array_equal(
                got.astype(np.float64), want.astype(np.float64)):
            fails.append(f"{name}: got {got.tolist()!r}, "
                         f"want {want.tolist()!r}")

    def expect_raise(name, fn):
        try:
            fn()
            fails.append(f"{name}: expected RuntimeError (blow-up guard)")
        except RuntimeError:
            pass
        except Exception as exc:                       # noqa: BLE001
            fails.append(f"{name}: wrong exception {type(exc).__name__}")

    try:
        ids = A(np.array([5, 1, 3, 1, 0], dtype=np.int64))
        check("asarray/to_host roundtrip", ids, [5, 1, 3, 1, 0])
        check("take", ops.take(ids, A(np.array([2, 0], np.int64))), [3, 5])
        check("mask", ops.mask(ids, A(np.array([True, False, True, False,
                                                False]))), [5, 3])
        check("concat", ops.concat([ids, A(np.array([9], np.int64))]),
              [5, 1, 3, 1, 0, 9])
        check("nonzero", ops.nonzero(A(np.array([False, True, False, True]))),
              [1, 3])
        check("full", ops.full(3, 7), [7, 7, 7])
        check("arange", ops.arange(4), [0, 1, 2, 3])
        check("isin", ops.isin(ids, [1, 5]),
              [True, True, False, True, False])
        check("searchsorted",
              ops.searchsorted(A(np.array([1, 3, 3, 8], np.int64)),
                               A(np.array([0, 3, 9], np.int64)), side="right"),
              [0, 3, 4])
        # lexsort: last col primary, stable within ties
        c0 = A(np.array([1, 0, 1, 0], np.int64))
        c1 = A(np.array([2, 2, 1, 1], np.int64))
        check("lexsort", ops.lexsort([c0, c1]), [3, 2, 1, 0])
        check("distinct_indices",
              ops.distinct_indices(A(np.array([3, 1, 3, 7, 1], np.int64))),
              [0, 1, 3])
        check("where",
              ops.where(A(np.array([True, False, True])),
                        A(np.array([1, 2, 3], np.int64)),
                        A(np.array([7, 8, 9], np.int64))),
              [1, 8, 3])

        check("scan", ops.scan(3, 7), [3, 4, 5, 6])

        csr = _conf_csr()
        rows = A(np.array([1, 0, 2, 3], np.int64))
        ridx, nbr, epos = ops.expand(csr, rows)
        check("expand.row_idx", ridx, [0, 0, 0, 1, 1, 3])
        check("expand.nbr", nbr, [3, 7, 9, 10, 12, 12])
        check("expand.edge_pos", epos, [2, 3, 4, 0, 1, 5])
        expect_raise("expand.max_out", lambda: ops.expand(csr, rows,
                                                          max_out=2))

        found, ipos = ops.intersect(csr, A(np.array([0, 1, 1, 3], np.int64)),
                                    A(np.array([12, 8, 9, 12], np.int64)))
        check("intersect.found", found, [True, False, True, True])
        # dtype is part of the contract: callers compose the found mask with
        # ~/& and bitwise-not on an int 0/1 column corrupts silently
        if np.asarray(H(found)).dtype != np.bool_:
            fails.append("intersect.found: mask dtype "
                         f"{np.asarray(H(found)).dtype}, want bool")
        fh = np.asarray(H(found)).astype(bool)
        check("intersect.edge_pos", np.asarray(H(ipos))[fh], [1, 4, 5])

        lidx, ridx2 = ops.join(A(np.array([2, 1, 2, 5], np.int64)),
                               A(np.array([2, 2, 7, 1], np.int64)))
        check("join.lidx (sort-merge order)", lidx, [1, 0, 0, 2, 2])
        check("join.ridx (sort-merge order)", ridx2, [3, 0, 1, 0, 1])
        expect_raise("join.max_out",
                     lambda: ops.join(A(np.array([2, 1, 2, 5], np.int64)),
                                      A(np.array([2, 2, 7, 1], np.int64)),
                                      max_out=2))

        # combine_keys: grouping identity + lexicographic order
        key = H(ops.combine_keys([A(np.array([1, 1, 2, 2], np.int64)),
                                  A(np.array([1, 2, 1, 1], np.int64))]))
        key = np.asarray(key)
        if not (key[2] == key[3] and key[0] < key[1] < key[2]
                and key[0] != key[1]):
            fails.append(f"combine_keys: packed order/identity broken: "
                         f"{key.tolist()!r}")

        keys = A(np.array([3, 1, 3, 1, 7], np.int64))
        col = A(np.array([1, 2, 3, 4, 5], np.int64))
        first, aggs = ops.group_reduce(
            keys, {"c": ("COUNT", col), "s": ("SUM", col),
                   "lo": ("MIN", col), "hi": ("MAX", col),
                   "av": ("AVG", col)})
        check("group_reduce.first", first, [1, 0, 4])
        check("group_reduce.COUNT", aggs["c"], [2, 2, 1])
        check("group_reduce.SUM", aggs["s"], [6, 4, 5])
        check("group_reduce.MIN", aggs["lo"], [2, 1, 5])
        check("group_reduce.MAX", aggs["hi"], [4, 3, 5])
        check("group_reduce.AVG", aggs["av"], [3.0, 2.0, 5.0])

        if getattr(ops, "supports_chains", False):
            _conformance_chain(ops, fails)

        # operator-boundary dtype contract, pinned on every backend: bool
        # masks, integer id columns, the declared index dtype on device
        # sets
        fails.extend(dtype_contract_failures(ops))
    except Exception as exc:                           # noqa: BLE001
        fails.append(f"conformance aborted: {type(exc).__name__}: {exc}")
    return fails
