"""Delta overlay + MVCC-lite snapshots over the frozen CSR store.

``MutableGraphStore`` wraps a frozen :class:`~repro_torch.graphdb.storage.GraphStore`
with an append-friendly overlay:

- per-triple **sorted insert buffers** exposed to the engine as compact-row
  CSR *views* (:class:`DeltaAdj`) that flow through the existing
  expand/intersect kernels of every backend unchanged,
- **edge tombstones** (a second compact-row CSR view per (triple, direction))
  probed with the same intersect primitive,
- **vertex tombstones** (small sorted id arrays) and **extension vertices**
  with ids appended *above* the base id space (``gid >= base.n_vertices``) so
  the base type ranges never shift,
- **overlay property columns** for new vertices/edges; properties are
  version-immutable (insert/delete only, no in-place updates), so property
  gathers never need snapshot filtering — only the id/slot -> value mapping
  grows.

**MVCC-lite**: every mutation bumps ``version``. ``snapshot()`` returns an
immutable :class:`Snapshot` — built arrays, not live dicts — that sees
``base ∪ inserts − tombstones`` as of its pin. Writers never block readers:
later mutations build *new* views; views for untouched (triple, direction)
pairs are reused by object identity, which keeps the backends' ``id()``-keyed
device caches warm across snapshots. View capacities are pow2-bucketed
(rows and nnz independently) so device uploads and kernel shapes plateau.

``compact()`` merges the overlay into a rebuilt base via
:func:`~repro_torch.graphdb.storage.build_store` with *canonical renumbering*
(per type: surviving base vertices in original order, then extension
vertices in insertion order), which makes the compacted store array-identical
to a from-scratch build over the same logical graph. Snapshots pinned below
the compaction version are retired (``Snapshot.retired``) — the low-water
mark is the compaction itself.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import numpy as np

# the engine catches this class (``core/errors.py``); it is re-exported
# here, never defined a second time
from repro_torch.core.errors import StaleSnapshotError  # noqa: F401
from repro_torch.core.schema import EdgeTriple
from repro_torch.graphdb.storage import CSR, GraphStore, build_store

INT64_MIN = np.iinfo(np.int64).min
# Sorted row-key sentinel: larger than any real id that fits the backends'
# int32 staging envelope, so searchsorted(keys, gid) never lands past the
# trailing sentinel block and the sentinel row is always empty.
SENTINEL_KEY = 2**31 - 2


def _pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


@dataclasses.dataclass(frozen=True)
class DeltaAdj:
    """A compact-row CSR view over one (triple, direction) of the overlay.

    ``keys[:n_rows]`` are the sorted global ids that have overlay entries;
    the tail is padded with ``SENTINEL_KEY``. ``csr`` has ``len(keys)`` rows
    (+1 sentinel offsets row): real rows first, then empty padded rows, so any
    ``searchsorted(keys, gid)`` result indexes a valid (possibly empty) row.
    ``csr.indices``/``csr.pos`` are pow2-padded beyond ``nnz``; the padding is
    unreachable through ``indptr``.
    """
    keys: np.ndarray        # int64[row_cap] sorted, SENTINEL_KEY padded
    csr: CSR                # indptr int64[row_cap+1]; indices/pos int64[nnz_cap]
    n_rows: int
    nnz: int

    @property
    def row_cap(self) -> int:
        return int(self.keys.shape[0])

    @property
    def nnz_cap(self) -> int:
        return int(self.csr.indices.shape[0])


def _build_adj(keys: np.ndarray, nbrs: np.ndarray,
               pos: np.ndarray | None) -> DeltaAdj | None:
    """Assemble a DeltaAdj from parallel (key gid, neighbor gid[, pos]) arrays."""
    if keys.shape[0] == 0:
        return None
    order = np.lexsort((nbrs, keys))
    k, v = keys[order], nbrs[order]
    p = pos[order] if pos is not None else None
    uk, counts = np.unique(k, return_counts=True)
    r, nnz = int(uk.shape[0]), int(v.shape[0])
    row_cap = _pow2(r + 1, 4)
    nnz_cap = _pow2(nnz, 8)
    key_col = np.full(row_cap, SENTINEL_KEY, dtype=np.int64)
    key_col[:r] = uk
    indptr = np.full(row_cap + 1, nnz, dtype=np.int64)
    indptr[0] = 0
    indptr[1:r + 1] = np.cumsum(counts)
    indices = np.zeros(nnz_cap, dtype=np.int64)
    indices[:nnz] = v
    pcol = None
    if p is not None:
        pcol = np.zeros(nnz_cap, dtype=np.int64)
        pcol[:nnz] = p
    return DeltaAdj(keys=key_col, csr=CSR(indptr, indices, pcol),
                    n_rows=r, nnz=nnz)


@dataclasses.dataclass
class Snapshot:
    """Immutable pin of the overlay state at one version.

    ``ins``/``dels`` map ``(triple, "out"|"in")`` to DeltaAdj views (only
    non-empty entries present). ``ext`` maps vertex type -> sorted alive
    extension gids; ``dead`` maps vertex type -> sorted tombstoned gids
    (base and extension). ``retired`` flips when a compaction rebases the
    store underneath — executing a retired snapshot raises.
    """
    version: int
    ins: dict[tuple[EdgeTriple, str], DeltaAdj]
    dels: dict[tuple[EdgeTriple, str], DeltaAdj]
    ext: dict[str, np.ndarray]
    dead: dict[str, np.ndarray]
    retired: bool = False

    def __post_init__(self):
        self._touched = frozenset(t for (t, _k) in self.ins) | \
            frozenset(t for (t, _k) in self.dels)

    @property
    def is_empty(self) -> bool:
        return not (self.ins or self.dels or self.ext or self.dead)

    @property
    def touched_triples(self) -> frozenset:
        return self._touched

    @property
    def has_vertex_delta(self) -> bool:
        return bool(self.ext or self.dead)

    def dead_for(self, vtype: str) -> np.ndarray | None:
        return self.dead.get(vtype)

    def affects_chain(self, triples) -> bool:
        """Fused chains must fall back to the per-hop loop when the snapshot
        could change any hop's adjacency: tombstoned vertices filter every
        expansion target, and overlay/tombstoned edges change hop outputs.
        Extension-only snapshots (new isolated vertices) leave chains exact:
        an extension id can only enter a pattern through a scan, never
        mid-chain."""
        if self.dead:
            return True
        tt = self._touched
        if not tt:
            return False
        return any(t in tt for t in triples)


class MutableGraphStore:
    """A GraphStore-shaped mutable overlay. Duck-types the frozen store:

    - ``type_range``/``v_offset``/``out_csr``/``in_csr``/... delegate to the
      base (engine addressing stays base-layout; extension ids live above),
    - ``v_count``/``n_vertices``/``n_edges`` report *live* counts (the cost
      model sees overlay occupancy),
    - ``vertex_prop``/``edge_prop``/``type_of_ids`` are overlay-aware.

    Thread-safe: mutations, ``snapshot()`` and ``compact()`` serialize on an
    internal lock (QueryServer applies writes on its worker thread while the
    admission thread pins snapshots).
    """

    def __init__(self, base: GraphStore):
        if isinstance(base, MutableGraphStore):
            raise TypeError("cannot wrap a MutableGraphStore")
        self._base = base
        self._lock = threading.RLock()
        self._base_vertices = int(base.n_vertices)
        self._base_edges = int(base.n_edges)
        self.version = 0
        self.mutations = 0
        self.compactions: list[dict] = []
        # edge overlay: triple -> {(gsrc, gdst): slot} / {(gsrc, gdst)}
        self._ins: dict[EdgeTriple, dict[tuple[int, int], int]] = {}
        self._dels: dict[EdgeTriple, set[tuple[int, int]]] = {}
        self._edge_touched: dict[EdgeTriple, int] = {}
        self._next_slot = 0
        # vertex overlay (extension ids = base_vertices + slot)
        self._ext_type: list[str] = []
        self._ext_alive: list[bool] = []
        self._dead_base: set[int] = set()
        self._vtx_touched = 0
        # overlay property stores: prop -> {slot: int64 value}
        self._ext_props: dict[str, dict[int, int]] = {}
        self._eprops_over: dict[str, dict[int, int]] = {}
        self._prop_ver = 0          # bumps when overlay prop columns change
        # live per-type counts (kept incrementally; v_count reads this)
        self._live_count = dict(base.v_count)
        # snapshot machinery
        self._cur_snap: Snapshot | None = None
        self._view_cache: dict[tuple, tuple[int, DeltaAdj | None]] = {}
        self._vtx_views: tuple[int, dict, dict] | None = None
        self._snapshots: list = []      # weakrefs to issued snapshots
        self._col_cache: dict[tuple, np.ndarray] = {}

    def __deepcopy__(self, memo):
        """Frozen logical copy: overlay state is cloned, the immutable base
        CSR (and any operator-set caches living on it) is *shared*.  This is
        the snapshot-isolation test oracle — a copy taken at version V keeps
        answering at V while the original keeps mutating."""
        with self._lock:
            clone = MutableGraphStore(self._base)
            clone.version = self.version
            clone.mutations = self.mutations
            clone.compactions = [dict(e) for e in self.compactions]
            clone._ins = {t: dict(m) for t, m in self._ins.items()}
            clone._dels = {t: set(s) for t, s in self._dels.items()}
            clone._edge_touched = dict(self._edge_touched)
            clone._next_slot = self._next_slot
            clone._ext_type = list(self._ext_type)
            clone._ext_alive = list(self._ext_alive)
            clone._dead_base = set(self._dead_base)
            clone._vtx_touched = self._vtx_touched
            clone._ext_props = {k: dict(v) for k, v in self._ext_props.items()}
            clone._eprops_over = {k: dict(v)
                                  for k, v in self._eprops_over.items()}
            clone._prop_ver = self._prop_ver
            clone._live_count = dict(self._live_count)
            memo[id(self)] = clone
            return clone

    # ------------------------------------------------------------ delegation
    @property
    def base(self) -> GraphStore:
        return self._base

    @property
    def schema(self):
        return self._base.schema

    @property
    def v_offset(self):
        return self._base.v_offset

    @property
    def out_csr(self):
        return self._base.out_csr

    @property
    def in_csr(self):
        return self._base.in_csr

    @property
    def v_props(self):
        return self._base.v_props

    @property
    def e_props(self):
        return self._base.e_props

    @property
    def str_vocab(self):
        return self._base.str_vocab

    def type_range(self, vtype: str):
        return self._base.type_range(vtype)

    def _sorted_types(self):
        return self._base._sorted_types()

    def triple_index(self):
        return self._base.triple_index()

    def encode_str(self, prop: str, value: str) -> int:
        return self._base.encode_str(prop, value)

    # ------------------------------------------------------------ live meta
    @property
    def v_count(self) -> dict[str, int]:
        return self._live_count

    @property
    def n_vertices(self) -> int:
        return sum(self._live_count.values())

    @property
    def n_edges(self) -> int:
        d = sum(len(m) for m in self._ins.values()) - \
            sum(len(s) for s in self._dels.values())
        return self._base_edges + d

    @property
    def base_n_vertices(self) -> int:
        return self._base_vertices

    @property
    def id_space(self) -> int:
        """Upper bound of the global id space (base + extension slots)."""
        return self._base_vertices + len(self._ext_type)

    @property
    def overlay_edge_slots(self) -> int:
        """Allocated overlay edge slots (overlay ``pos`` values live in
        ``[base_edges, base_edges + overlay_edge_slots)``)."""
        return self._next_slot

    @property
    def compaction_epoch(self) -> int:
        """Bumps only when compaction swaps the base CSR objects — the
        cache-invalidation key for anything derived from base arrays
        (fused-chain specs, device property columns)."""
        return len(self.compactions)

    def delta_edge_counts(self) -> dict[EdgeTriple, int]:
        """Net overlay edge count per triple (Statistics hook)."""
        out: dict[EdgeTriple, int] = {}
        for t, m in self._ins.items():
            if m:
                out[t] = out.get(t, 0) + len(m)
        for t, s in self._dels.items():
            if s:
                out[t] = out.get(t, 0) - len(s)
        return out

    # --------------------------------------------------- overlay-aware reads
    def type_of_ids(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        bv = self._base_vertices
        out = self._base.type_of_ids(np.where(ids < bv, ids, 0))
        m = ids >= bv
        if m.any():
            ti = {t: i for i, t in enumerate(self._base._sorted_types())}
            ext_ti = np.array([ti[t] for t in self._ext_type], dtype=np.int64)
            out = np.where(m, ext_ti[np.clip(ids - bv, 0, len(ext_ti) - 1)],
                           out)
        return out

    def ext_vertex_prop_column(self, prop: str) -> np.ndarray:
        """Dense pow2-padded column over extension slots (INT64_MIN missing)."""
        with self._lock:
            key = ("v", prop, self._prop_ver, len(self._ext_type))
            col = self._col_cache.get(key)
            if col is None:
                cap = _pow2(max(len(self._ext_type), 1))
                col = np.full(cap, INT64_MIN, dtype=np.int64)
                for slot, v in self._ext_props.get(prop, {}).items():
                    col[slot] = v
                self._col_cache[key] = col
            return col

    def overlay_edge_prop_column(self, prop: str) -> np.ndarray:
        """Dense pow2-padded column over overlay edge slots."""
        with self._lock:
            key = ("e", prop, self._prop_ver, self._next_slot)
            col = self._col_cache.get(key)
            if col is None:
                cap = _pow2(max(self._next_slot, 1))
                col = np.full(cap, INT64_MIN, dtype=np.int64)
                for slot, v in self._eprops_over.get(prop, {}).items():
                    col[slot] = v
                self._col_cache[key] = col
            return col

    def vertex_prop(self, ids: np.ndarray, prop: str) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        bv = self._base_vertices
        out = self._base.vertex_prop(np.where(ids < bv, ids, 0), prop)
        m = ids >= bv
        if m.any():
            col = self.ext_vertex_prop_column(prop)
            out = np.where(m, col[np.clip(ids - bv, 0, col.shape[0] - 1)], out)
        return out

    def edge_prop(self, triple_ids: np.ndarray, pos: np.ndarray,
                  prop: str) -> np.ndarray:
        triple_ids = np.asarray(triple_ids, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        be = self._base_edges
        over = pos >= be
        out = self._base.edge_prop(np.where(over, -1, triple_ids),
                                   np.where(over, 0, pos), prop)
        if over.any():
            col = self.overlay_edge_prop_column(prop)
            out = np.where(
                over, col[np.clip(pos - be, 0, col.shape[0] - 1)], out)
        return out

    # ------------------------------------------------------------- mutations
    def _encode(self, prop: str, value) -> int:
        if isinstance(value, str):
            code = self._base.encode_str(prop, value)
            if code < 0:
                raise ValueError(
                    f"unknown string {value!r} for {prop!r}: the string "
                    "vocabulary is frozen with the base store")
            return code
        return int(value)

    def _bump(self, triple: EdgeTriple | None = None, vertex: bool = False):
        self.version += 1
        self.mutations += 1
        self._cur_snap = None
        if triple is not None:
            self._edge_touched[triple] = self.version
        if vertex:
            self._vtx_touched = self.version

    def _alive(self, gid: int, vtype: str) -> bool:
        bv = self._base_vertices
        if gid < bv:
            lo, hi = self._base.type_range(vtype)
            return lo <= gid < hi and gid not in self._dead_base
        slot = gid - bv
        return (slot < len(self._ext_type)
                and self._ext_type[slot] == vtype and self._ext_alive[slot])

    def _resolve_triple(self, triple) -> EdgeTriple:
        if not isinstance(triple, EdgeTriple):
            triple = EdgeTriple(*triple)
        if triple not in self._base.out_csr:
            raise KeyError(f"unknown edge triple {triple}")
        return triple

    def _base_has_edge(self, t: EdgeTriple, src: int, dst: int) -> bool:
        if src >= self._base_vertices:
            return False
        csr = self._base.out_csr[t]
        lo, hi = self._base.type_range(t.src)
        if not (lo <= src < hi):
            return False
        i0, i1 = int(csr.indptr[src - lo]), int(csr.indptr[src - lo + 1])
        j = int(np.searchsorted(csr.indices[i0:i1], dst))
        return j < i1 - i0 and int(csr.indices[i0 + j]) == dst

    def insert_vertex(self, vtype: str, props: dict | None = None) -> int:
        """Insert a vertex; returns its (extension) global id."""
        with self._lock:
            if vtype not in self._base.v_offset:
                raise KeyError(f"unknown vertex type {vtype!r}")
            slot = len(self._ext_type)
            self._ext_type.append(vtype)
            self._ext_alive.append(True)
            for k, v in (props or {}).items():
                self._ext_props.setdefault(k, {})[slot] = self._encode(k, v)
            if props:
                self._prop_ver += 1
            self._live_count[vtype] += 1
            self._bump(vertex=True)
            return self._base_vertices + slot

    def delete_vertex(self, gid: int) -> bool:
        """Tombstone a vertex. Incident edges are hidden at read time and
        dropped physically at compaction."""
        with self._lock:
            gid = int(gid)
            bv = self._base_vertices
            if gid >= bv:
                slot = gid - bv
                if slot >= len(self._ext_type) or not self._ext_alive[slot]:
                    return False
                self._ext_alive[slot] = False
                self._live_count[self._ext_type[slot]] -= 1
            else:
                if gid in self._dead_base:
                    return False
                self._dead_base.add(gid)
                types = self._base._sorted_types()
                tname = types[int(self._base.type_of_ids(
                    np.array([gid], dtype=np.int64))[0])]
                self._live_count[tname] -= 1
            self._bump(vertex=True)
            return True

    def insert_edge(self, triple, src: int, dst: int,
                    props: dict | None = None) -> bool:
        """Insert an edge between live vertices. Returns False if it already
        exists. Re-inserting a tombstoned base edge resurrects it with its
        original properties (``props`` must be None in that case)."""
        with self._lock:
            t = self._resolve_triple(triple)
            src, dst = int(src), int(dst)
            if not self._alive(src, t.src):
                raise ValueError(f"src {src} is not a live {t.src!r} vertex")
            if not self._alive(dst, t.dst):
                raise ValueError(f"dst {dst} is not a live {t.dst!r} vertex")
            key = (src, dst)
            dels = self._dels.get(t)
            if dels is not None and key in dels:
                if props:
                    raise ValueError(
                        "cannot attach new properties when resurrecting a "
                        "tombstoned base edge")
                dels.discard(key)
                self._bump(triple=t)
                return True
            if self._base_has_edge(t, src, dst):
                return False
            ins = self._ins.setdefault(t, {})
            if key in ins:
                return False
            slot = self._next_slot
            self._next_slot += 1
            ins[key] = slot
            for k, v in (props or {}).items():
                self._eprops_over.setdefault(k, {})[slot] = self._encode(k, v)
            if props:
                self._prop_ver += 1
            self._bump(triple=t)
            return True

    def delete_edge(self, triple, src: int, dst: int) -> bool:
        with self._lock:
            t = self._resolve_triple(triple)
            key = (int(src), int(dst))
            ins = self._ins.get(t)
            if ins is not None and key in ins:
                del ins[key]
                self._bump(triple=t)
                return True
            if self._base_has_edge(t, key[0], key[1]):
                dels = self._dels.setdefault(t, set())
                if key in dels:
                    return False
                dels.add(key)
                self._bump(triple=t)
                return True
            return False

    # ------------------------------------------------------------- snapshots
    def _view(self, t: EdgeTriple, kind: str, which: str) -> DeltaAdj | None:
        key = (t, kind, which)
        ent = self._view_cache.get(key)
        need = self._edge_touched.get(t, 0)
        if ent is not None and ent[0] >= need:
            return ent[1]
        if which == "ins":
            items = self._ins.get(t) or {}
            if items:
                src = np.fromiter((k[0] for k in items), np.int64, len(items))
                dst = np.fromiter((k[1] for k in items), np.int64, len(items))
                pos = np.fromiter(items.values(), np.int64, len(items))
                pos = pos + self._base_edges
                adj = (_build_adj(src, dst, pos) if kind == "out"
                       else _build_adj(dst, src, pos))
            else:
                adj = None
        else:
            pairs = self._dels.get(t) or ()
            if pairs:
                src = np.fromiter((k[0] for k in pairs), np.int64, len(pairs))
                dst = np.fromiter((k[1] for k in pairs), np.int64, len(pairs))
                adj = (_build_adj(src, dst, None) if kind == "out"
                       else _build_adj(dst, src, None))
            else:
                adj = None
        self._view_cache[key] = (self.version, adj)
        return adj

    def _vertex_views(self) -> tuple[dict, dict]:
        ent = self._vtx_views
        if ent is not None and ent[0] >= self._vtx_touched:
            return ent[1], ent[2]
        bv = self._base_vertices
        ext: dict[str, list[int]] = {}
        dead: dict[str, list[int]] = {}
        for slot, t in enumerate(self._ext_type):
            (ext if self._ext_alive[slot] else dead).setdefault(t, []).append(
                bv + slot)
        if self._dead_base:
            types = self._base._sorted_types()
            gids = np.array(sorted(self._dead_base), dtype=np.int64)
            for ti, gid in zip(self._base.type_of_ids(gids), gids):
                dead.setdefault(types[int(ti)], []).append(int(gid))
        ext_a = {t: np.array(sorted(v), dtype=np.int64)
                 for t, v in ext.items()}
        dead_a = {t: np.array(sorted(v), dtype=np.int64)
                  for t, v in dead.items()}
        self._vtx_views = (self.version, ext_a, dead_a)
        return ext_a, dead_a

    def snapshot(self) -> Snapshot:
        """Pin the current version. Cheap: views for untouched (triple,
        direction) pairs are reused by identity across snapshots."""
        with self._lock:
            if self._cur_snap is not None:
                return self._cur_snap
            ins: dict = {}
            dels: dict = {}
            for t in self._edge_touched:
                for kind in ("out", "in"):
                    a = self._view(t, kind, "ins")
                    if a is not None:
                        ins[(t, kind)] = a
                    a = self._view(t, kind, "del")
                    if a is not None:
                        dels[(t, kind)] = a
            ext, dead = self._vertex_views()
            snap = Snapshot(version=self.version, ins=ins, dels=dels,
                            ext=ext, dead=dead)
            self._snapshots.append(weakref.ref(snap))
            self._cur_snap = snap
            return snap

    def _live_snapshots(self) -> list[Snapshot]:
        out, keep = [], []
        for ref in self._snapshots:
            s = ref()
            if s is not None:
                keep.append(ref)
                if not s.retired:
                    out.append(s)
        self._snapshots = keep
        return out

    # ------------------------------------------------------------ compaction
    def compact(self) -> dict:
        """Merge the overlay into a rebuilt base CSR (canonical renumbering:
        identical arrays to a from-scratch ``build_store`` over the same
        logical graph). Retires snapshots pinned below the new version."""
        with self._lock:
            t0 = time.perf_counter()
            base = self._base
            bv = self._base_vertices
            schema = base.schema
            # --- vertex renumbering: old global id -> new LOCAL id, per type
            old2new = np.full(self.id_space, -1, dtype=np.int64)
            new_count: dict[str, int] = {}
            new_vprops: dict[str, dict[str, np.ndarray]] = {}
            for t in schema.vertex_types:
                lo, hi = base.type_range(t)
                base_ids = np.arange(lo, hi, dtype=np.int64)
                if self._dead_base:
                    dead = np.array(sorted(self._dead_base), dtype=np.int64)
                    base_ids = base_ids[~np.isin(base_ids, dead)]
                ext_ids = np.array(
                    [bv + s for s, et in enumerate(self._ext_type)
                     if et == t and self._ext_alive[s]], dtype=np.int64)
                keep = np.concatenate([base_ids, ext_ids])
                old2new[keep] = np.arange(keep.shape[0], dtype=np.int64)
                new_count[t] = int(keep.shape[0])
                props = set(base.v_props.get(t, {}))
                for p, slots in self._ext_props.items():
                    if any(self._ext_type[s] == t and self._ext_alive[s]
                           for s in slots):
                        props.add(p)
                cols: dict[str, np.ndarray] = {}
                for p in props:
                    col = np.full(keep.shape[0], INT64_MIN, dtype=np.int64)
                    bcol = base.v_props.get(t, {}).get(p)
                    if bcol is not None:
                        col[:base_ids.shape[0]] = bcol[base_ids - lo]
                    over = self._ext_props.get(p, {})
                    for j, gid in enumerate(ext_ids):
                        v = over.get(int(gid) - bv)
                        if v is not None:
                            col[base_ids.shape[0] + j] = v
                    cols[p] = col
                if cols:
                    new_vprops[t] = cols
            # --- edges: surviving base ∪ overlay, filtered by live endpoints
            alive = old2new >= 0
            edges: dict[EdgeTriple, tuple[np.ndarray, np.ndarray]] = {}
            new_eprops: dict[EdgeTriple, dict[str, np.ndarray]] = {}
            merged = dropped = 0
            for t, csr in base.out_csr.items():
                lo, _ = base.type_range(t.src)
                deg = np.diff(csr.indptr)
                gsrc = np.repeat(
                    np.arange(deg.shape[0], dtype=np.int64) + lo, deg)
                gdst = csr.indices
                epos = np.arange(gdst.shape[0], dtype=np.int64)
                keep = alive[gsrc] & alive[gdst]
                dset = self._dels.get(t)
                if dset:
                    dk = np.array([s * self.id_space + d for s, d in dset],
                                  dtype=np.int64)
                    keep &= ~np.isin(gsrc * self.id_space + gdst, dk)
                dropped += int((~keep).sum())
                gsrc, gdst, epos = gsrc[keep], gdst[keep], epos[keep]
                ins = self._ins.get(t) or {}
                islots = np.fromiter(ins.values(), np.int64, len(ins))
                isrc = np.fromiter((k[0] for k in ins), np.int64, len(ins))
                idst = np.fromiter((k[1] for k in ins), np.int64, len(ins))
                ikeep = alive[isrc] & alive[idst]
                merged += int(ikeep.sum())
                isrc, idst, islots = isrc[ikeep], idst[ikeep], islots[ikeep]
                all_src = old2new[np.concatenate([gsrc, isrc])]
                all_dst = old2new[np.concatenate([gdst, idst])]
                edges[t] = (all_src, all_dst)
                props = set(base.e_props.get(t, {}))
                for p, slots in self._eprops_over.items():
                    if any(s in slots for s in islots):
                        props.add(p)
                cols = {}
                for p in props:
                    col = np.full(all_src.shape[0], INT64_MIN, dtype=np.int64)
                    bcol = base.e_props.get(t, {}).get(p)
                    if bcol is not None:
                        col[:gsrc.shape[0]] = bcol[epos]
                    over = self._eprops_over.get(p, {})
                    for j, s in enumerate(islots):
                        v = over.get(int(s))
                        if v is not None:
                            col[gsrc.shape[0] + j] = v
                    cols[p] = col
                if cols:
                    new_eprops[t] = cols
            new_base = build_store(schema, new_count, edges,
                                   v_props=new_vprops, e_props=new_eprops,
                                   str_vocab=base.str_vocab)
            retired = 0
            for s in self._live_snapshots():
                if s.version <= self.version:
                    s.retired = True
                    retired += 1
            event = {
                "version": self.version + 1,
                "merged_edges": merged,
                "dropped_edges": dropped,
                "ext_vertices": sum(self._ext_alive),
                "dead_vertices": len(self._dead_base)
                + self._ext_alive.count(False),
                "retired_snapshots": retired,
                "wall_s": round(time.perf_counter() - t0, 6),
            }
            self._base = new_base
            self._base_vertices = int(new_base.n_vertices)
            self._base_edges = int(new_base.n_edges)
            self._ins.clear()
            self._dels.clear()
            self._edge_touched.clear()
            self._next_slot = 0
            self._ext_type = []
            self._ext_alive = []
            self._dead_base = set()
            self._ext_props = {}
            self._eprops_over = {}
            self._prop_ver += 1
            self._live_count = dict(new_base.v_count)
            self._view_cache.clear()
            self._vtx_views = None
            self._col_cache.clear()
            self._cur_snap = None
            self.version += 1
            event["wall_s"] = round(time.perf_counter() - t0, 6)
            self.compactions.append(event)
            return event

    # ---------------------------------------------------------------- ledger
    def delta_info(self) -> dict:
        """Overlay occupancy / snapshot spread / compaction events, rendered
        as the ``-- delta --`` EXPLAIN section."""
        with self._lock:
            ins_e = sum(len(m) for m in self._ins.values())
            del_e = sum(len(s) for s in self._dels.values())
            live = [s.version for s in self._live_snapshots()]
            info = {
                "version": self.version,
                "mutations": self.mutations,
                "overlay_edges": ins_e,
                "tombstoned_edges": del_e,
                "ext_vertices": self._ext_alive.count(True),
                "dead_vertices": len(self._dead_base)
                + self._ext_alive.count(False),
                "overlay_triples": sum(
                    1 for t in set(self._ins) | set(self._dels)
                    if self._ins.get(t) or self._dels.get(t)),
                "snapshots_live": len(live),
                "snapshot_spread": (f"{min(live)}..{max(live)}"
                                    if live else "-"),
                "compactions": len(self.compactions),
            }
            if self.compactions:
                ev = self.compactions[-1]
                info["last_compaction"] = (
                    f"v{ev['version']} merged={ev['merged_edges']} "
                    f"dropped={ev['dropped_edges']} wall_s={ev['wall_s']}")
            return info
