"""Torch backend — device-resident binding tables on ``torch.Tensor``s.

Registers the ``"torch"`` PhysicalSpec (cuda) and, on request, one spec per
other device (``torch_spec("cpu")`` -> ``"torch[cpu]"``), so plan caches and
the per-store operator cache never mix devices.  It is the twin of the
reference's ``JaxOperators`` (``repro/graphdb/jax_backend.py``).
OperatorSet v2 (DESIGN.md §7): every operator takes and returns tensors
on the set's device, so the binding table stays there
across all plan steps — pattern loop and relational tail — and crosses to
the host once, at delivery (``to_host``).

- ``expand``    -> ``torchops.csr_expand_flat``: a flat row-major CSR
  gather sized exactly by the degree sum, which the ``max_out`` guard
  checks before anything is allocated.
- ``intersect`` -> the hand-written CUDA ``wcoj_intersect`` kernel: one
  launch per call, a per-probe walk down the CSR's fence index (built on
  the device at the CSR's first probe and cached beside it) for every
  degree (no padded-ELL tiles, no slabs, no split by degree).  On a CPU
  device the wrapper runs the kernel's plain version.
- relational tail: ``join`` is a sort-merge join, ``group_reduce`` a
  sorted-run reduction (int64 SUM, float64 AVG), ``combine_keys`` dense
  lexicographic ranks — the same row order as the numpy reference backend.
- ``chain_program`` -> ``FusedChain``: every ``ExpandChainNode`` (planned
  by the ``fuse_expand_chain`` physical rule) runs as ONE program
  (``torchops.build_fused_chain``) over pow2-bucketed capacities, with no
  host sync until its end and every probe inside it one ``wcoj_intersect``
  launch — one ``dispatch:fused_chain`` per chain.  On cuda each bucketed
  program runs eagerly at the first dispatch of its key, is captured after
  it as a CUDA graph (``capture:fused_chain``) and replayed at every later
  dispatch (``replay:fused_chain``), so its kernels cost the host one
  graph launch; on the CPU it runs eagerly.

Staging contracts: vertex ids, CSR offsets and property columns live on
the device as int32 (guarded at construction and at every upload);
``to_host`` widens int32 to int64 (the INT32_MIN missing-property sentinel
to INT64_MIN) and float32 to float64.  ``transfer_stats`` records every
data movement, and one ``sync`` wherever the host waits for the stream:
each value read back (row counts, blow-up guards, ``nonzero`` sizes, a
chain's control vector), each column copied either way, each barrier.
They are counted here, at the call, on every device.  ``kernel_stats``
records one ``dispatch:<kind>`` event per compound operator call.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.pattern import BOTH
from repro_torch.core.physical import (ChainStep, ExpandChainNode, ExpandNode,
                                       JoinNode, PlanNode,
                                       chain_fusable_predicates)
from repro_torch.core.physical_spec import (CostParams, OperatorSet,
                                            PhysicalSpec, register_spec)
from repro_torch.graphdb import torchops
from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                    wcoj_intersect)

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max
_I64_MIN = np.iinfo(np.int64).min

_AGGREGATES = ("COUNT", "SUM", "AVG", "MIN", "MAX")

# fused-chain bucketing (DESIGN.md §8): frontier sizes and per-hop
# capacities round up to powers of two with this floor, so the program
# cache is logarithmic in the size range a chain shape ever sees.  There is
# no volume cutoff: a chain is ready once its capacities are observed.
_CHAIN_MIN_BUCKET = 8
_CHAIN_PROGRAMS_PER_SHAPE = 4     # bucketed programs kept per chain
_CHAIN_SHAPES = 64                # chain handles kept per operator set


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def _require_device(device: torch.device):
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the torch backend runs on cuda, and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU versions")


class FusedChain:
    """One chain shape's fused-program handle (``OperatorSet.chain_program``).

    Lifecycle: the engine's first execution of the chain runs the per-hop
    loop and reports the observed per-hop expansion totals via
    ``observe()``; that fixes the pow2 capacity schedule (``caps``), and
    every later execution builds or reuses ONE program per (caps,
    input-bucket, IN-set buckets, empty IN-sets) key and runs the whole
    chain as one dispatch.  Capacities only grow (element-wise pow2 max);
    an execution whose true totals overflow the current caps returns
    ``None`` (the engine re-runs that one through the loop) and regrows the
    schedule for the next execution."""

    def __init__(self, ops: "TorchOperators", spec):
        self.ops = ops
        self.spec = spec
        self.caps: tuple | None = None
        self._progs: dict = {}  # (caps, in_bucket, vbuckets, empties) -> prog
        # pinned handles survive the operator set's chain-LRU eviction
        # (QueryServer hotness protection, DESIGN.md §9)
        self.pinned = False

    def ready(self) -> bool:
        return self.caps is not None

    def observe(self, sizes):
        caps = tuple(_pow2(max(int(s), 1), _CHAIN_MIN_BUCKET) for s in sizes)
        if self.caps is not None and len(self.caps) == len(caps):
            caps = tuple(max(a, b) for a, b in zip(self.caps, caps))
        self.caps = caps

    # ------------------------------------------------------------ marshaling
    def _build_desc(self):
        """Static program description for ``torchops.build_fused_chain`` +
        the ordered property-column requirements."""
        spec = self.spec
        vprops: list[str] = []
        eprops: list[str] = []

        def ref(r):
            if r[0] == "vprop":
                if r[2] not in vprops:
                    vprops.append(r[2])
                return ("vprop", r[1], vprops.index(r[2]))
            if r[0] == "eprop":
                if r[2] not in eprops:
                    eprops.append(r[2])
                return ("eprop", r[1], eprops.index(r[2]))
            return r

        s_map: dict[int, int] = {}
        v_map: dict[int, int] = {}
        for i, s in enumerate(spec.slots):
            if s[0] == "scalar":
                s_map[i] = len(s_map)
            else:
                v_map[i] = len(v_map)

        def sig(p):
            if p is None:
                return None
            if p[0] == "cmp":
                return ("cmp", p[1], ref(p[2]), s_map[p[3]])
            if p[0] == "in":
                return ("in", ref(p[1]), v_map[p[2]])
            return (p[0], tuple(sig(s) for s in p[1]))

        hops = []
        for h in spec.hops:
            orients = tuple((o.lo, o.hi, o.tidx, o.csr.pos is not None)
                            for o in h.orients)
            probes = tuple((p.from_alias, p.edge_alias, p.orient.lo,
                            p.orient.hi, p.vlo, p.vhi, p.orient.tidx,
                            p.orient.csr.pos is not None)
                           for p in h.probes)
            hops.append((h.from_alias, h.alias, h.edge_alias, orients,
                         probes, sig(h.pred_sig)))
        return (spec.source, tuple(hops)), tuple(vprops), tuple(eprops)

    # -------------------------------------------------------------- dispatch
    def _program(self, key, in_bucket: int, empties: tuple) -> "_Program":
        """The bucketed program of ``key``, built on a miss (LRU)."""
        prog = self._progs.get(key)
        if prog is not None:
            self._progs[key] = self._progs.pop(key)   # LRU touch
            return prog
        desc, vprops, eprops = self._build_desc()
        prog = _Program(desc, self.caps, in_bucket, empties, vprops, eprops)
        if len(self._progs) >= _CHAIN_PROGRAMS_PER_SHAPE:
            self._progs.pop(next(iter(self._progs)))
        self._progs[key] = prog
        self.ops.kernel_stats.record("compile", "fused_chain")
        return prog

    def run(self, src, nrows, scalars, value_lists, max_rows):
        """One fused dispatch; returns ``(rows, cols, n)`` with exact-size
        device columns, or ``None`` after a capacity overflow (caps regrow;
        the caller falls back to the per-hop loop for this execution)."""
        ops = self.ops
        n = int(nrows)
        in_bucket = _pow2(n, _CHAIN_MIN_BUCKET)
        vb = tuple(_pow2(max(len(v), 1)) for v in value_lists)
        # a runtime-empty IN-set is a *static* program variant (matches
        # nothing even under NOT/OR), part of the bucketed cache key
        empties = tuple(i for i, v in enumerate(value_lists) if len(v) == 0)
        key = (self.caps, in_bucket, vb, empties)
        prog = self._program(key, in_bucket, empties)
        src = ops._col(src).to(torch.int32)
        csrs = tuple((tuple(ops._csr_dev(o.csr) for o in h.orients),
                      tuple(ops._csr_dev(p.orient.csr, probe=True)
                            for p in h.probes))
                     for h in self.spec.hops)
        vp = tuple(ops._vprop_dev(p) for p in prog.vprops)
        # (offsets, column): a chain runs only where the snapshot leaves its
        # triples untouched, so its edges are all base edges
        ep = tuple(ops._eprop_dev(p)[:2] for p in prog.eprops)
        prog.stage(ops, src, n, (csrs, vp, ep), scalars, value_lists,
                   in_bucket, vb)
        cols, order, n_valid, needed = prog.launch(ops)
        ops.kernel_stats.record("dispatch", "fused_chain")
        ops.transfer_stats.sync()
        ctl = torch.cat([needed, n_valid[None]]).tolist()   # control sync
        needed_h, n_out = ctl[:-1], int(ctl[-1])
        top = max(needed_h)
        if top > _I32_MAX - 256:
            raise RuntimeError(
                f"intermediate blow-up: chain expansion would produce "
                f"~{float(top):.3g} rows (beyond the int32 staging "
                f"envelope)")
        if top > max_rows:
            raise RuntimeError(
                f"intermediate blow-up: chain expansion would produce "
                f"{top} rows > cap {max_rows}")
        if any(a > c for a, c in zip(needed_h, self.caps)):
            self.observe(needed_h)
            return None
        # copied out of the program's buffers before any other replay
        keep = order[:n_out]
        rows = cols["__rows"][keep]
        out = {k: v[keep] for k, v in cols.items()
               if k not in ("__rows", self.spec.source)}
        # an eager run's outputs go before a capture allocates the graph's
        # own, so the two never hold memory at once
        del cols, order, n_valid, needed, keep
        prog.capture(ops)
        return rows, out, n_out


def _read_tensors(inputs) -> tuple:
    """The device tensors a chain program reads by address: each
    orientation's ``(indptr, indices, pos)`` (its search index is not
    read), each probe's four, and the property columns."""
    csrs, vp, ep = inputs
    return (tuple(t for orients, _ in csrs for o in orients for t in o[:3])
            + tuple(t for _, probes in csrs for p in probes for t in p)
            + tuple(vp) + tuple(t for e in ep for t in e))


class _Program:
    """One bucketed program of a chain shape: the function
    (``torchops.build_fused_chain``), the property columns it reads, and
    the static buffers it reads its run values from.

    Before each run ``stage`` writes the run's values into buffers the
    program owns: the source column padded to its bucket with zeros, the
    source count ``n0`` as a device scalar, and the scalar slots and
    IN-sets (each sorted, padded to its bucket by repeating its largest
    value) packed in one int32 buffer that one staging copy fills.  The
    program reads the CSR, search-index and property tensors by address:
    it keeps them (``refs``), and binds fresh buffers, dropping any graph,
    when the device caches return other objects.

    On cuda the first run of a key runs eagerly and, once its outputs are
    copied out, the program is captured as one CUDA graph, which every
    later run replays; a run that overflows its capacities is not captured
    (they regrow).  On the CPU every run is eager.  ``launches`` and
    ``n_probes`` are the host-side counts the captured program made
    (``kernels.LAUNCHES``, ``probe:fused_chain``): the capture takes its
    launches back out of ``LAUNCHES``, since it ran nothing, and each
    replay adds them.  The set dispatches from one thread
    at a time (the server's one worker), so the counts ``LAUNCHES`` gained
    during a capture are the capture's.  A key whose capture fails runs
    eagerly until it is bound anew (``capture_failed:fused_chain``;
    ``capture_error`` keeps the error)."""

    def __init__(self, desc: tuple, caps: tuple, in_bucket: int,
                 empties: tuple, vprops: tuple, eprops: tuple):
        self.fn = torchops.build_fused_chain(desc, caps, in_bucket,
                                             self.probe,
                                             empty_values=empties)
        self.vprops = vprops
        self.eprops = eprops
        self.probes = 0
        self.refs: tuple | None = None
        self.args: tuple | None = None
        self.packed = None
        self.graph = None
        self.outs = None
        self.launches: dict = {}
        self.n_probes = 0
        self.capture_error: str | None = None

    def probe(self, *args):
        """A membership probe inside the program: one ``wcoj_intersect``
        launch on the card (the plain version on the CPU), counted as
        ``probe:fused_chain`` beside the ``dispatch:intersect`` of the
        per-operator probes."""
        self.probes += 1
        return wcoj_intersect(*args)

    def _bind(self, ops, inputs, n_scalars: int, vb: tuple, in_bucket: int):
        """Fresh static buffers over ``inputs``; any graph goes."""
        dev = ops.device
        self.graph = self.outs = self.capture_error = None
        self.refs = _read_tensors(inputs)
        packed = torch.zeros(n_scalars + sum(vb), dtype=torch.int32,
                             device=dev)
        vals, at = [], n_scalars
        for b in vb:
            vals.append(packed[at:at + b])
            at += b
        self.args = (torch.zeros(in_bucket, dtype=torch.int32, device=dev),
                     torch.zeros((), dtype=torch.int64, device=dev),
                     *inputs, packed[:n_scalars], tuple(vals))
        self.packed = packed

    def stage(self, ops, src, n: int, inputs, scalars, value_lists,
              in_bucket: int, vb: tuple):
        """Write this run's values into the static buffers (made anew, and
        any graph dropped, when the inputs' tensors are other objects)."""
        refs = _read_tensors(inputs)
        if self.refs is None or len(refs) != len(self.refs) or any(
                a is not b for a, b in zip(refs, self.refs)):
            self._bind(ops, inputs, len(scalars), vb, in_bucket)
        src_buf, n0 = self.args[:2]
        src_buf[:n].copy_(src)
        if n < src_buf.shape[0]:
            src_buf[n:].zero_()
        n0.fill_(n)
        host = np.zeros(self.packed.shape[0], dtype=np.int32)
        host[:len(scalars)] = scalars
        at = len(scalars)
        for v, b in zip(value_lists, vb):
            if len(v):
                s = np.sort(np.asarray(v, dtype=np.int32))
                host[at:at + len(s)] = s
                host[at + len(s):at + b] = s[-1]
            at += b
        ops.transfer_stats.record("h2d", host.size)
        if host.size:
            ops.transfer_stats.sync()     # a copy from pageable memory
            self.packed.copy_(torch.from_numpy(host))

    def capture(self, ops):
        """On cuda, capture the program once, on the set's side stream into
        the set's graph pool; a failure is kept and counted, and the key
        stays eager."""
        if (self.graph is not None or self.capture_error is not None
                or ops.device.type != "cuda"):
            return
        pool, side = ops._graph_pool()
        cur = torch.cuda.current_stream(ops.device)
        before, p0 = dict(kernels.LAUNCHES), self.probes
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(cur)
        try:
            with torch.cuda.device(ops.device), torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outs = self.fn(*self.args)
                finally:
                    graph.capture_end()
        except RuntimeError as exc:
            self.capture_error = f"{type(exc).__name__}: {exc}"[:500]
            ops.kernel_stats.record("capture_failed", "fused_chain")
            ops._graphs = None          # later captures take a fresh pool
            return
        finally:
            cur.wait_stream(side)
            # the capture launched nothing: its counts go to the replays
            self.launches = {k: v - before.get(k, 0)
                             for k, v in kernels.LAUNCHES.items()
                             if v != before.get(k, 0)}
            for k, v in self.launches.items():
                kernels.LAUNCHES[k] -= v
            self.n_probes = self.probes - p0
        self.graph, self.outs = graph, outs
        ops.kernel_stats.record("capture", "fused_chain")

    def launch(self, ops):
        """The program's outputs over the staged buffers: replayed from its
        graph, or run eagerly."""
        if self.graph is not None:
            self.graph.replay()
            ops.kernel_stats.record("replay", "fused_chain")
            if self.n_probes:
                ops.kernel_stats.record("probe", "fused_chain",
                                        self.n_probes)
            for k, v in self.launches.items():
                kernels.LAUNCHES[k] = kernels.LAUNCHES.get(k, 0) + v
            return self.outs
        p0 = self.probes
        out = self.fn(*self.args)
        if self.probes > p0:
            ops.kernel_stats.record("probe", "fused_chain", self.probes - p0)
        return out


class TorchOperators(OperatorSet):
    """Device-resident operator set: id columns are int32 tensors."""

    name = "torch"
    supports_chains = True
    compiled = False
    index_dtype = torch.int32

    def __init__(self, store, device: str | torch.device = "cuda"):
        super().__init__(store)
        self.device = torch.device(device)
        _require_device(self.device)
        self.on_host = self.device.type == "cpu"
        if max(store.n_vertices, store.n_edges) >= _I32_MAX:
            raise ValueError(
                "torch backend stages vertex ids and CSR offsets through "
                f"int32; store has {store.n_vertices} vertices / "
                f"{store.n_edges} edges")
        # id(csr) -> (weakref(csr), [indptr, indices, pos | None,
        # search index | None]); an entry leaves with its host CSR
        self._dev = {}
        # id(host overlay column) -> (weakref(column), device column)
        self._cols = {}
        # ("v"|"e", prop, compaction epoch) -> device property column(s)
        self._props = {}
        self._epoch = getattr(store, "compaction_epoch", 0)
        self._z32 = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._chains = {}     # (chain signature, csr ids) -> FusedChain
        # on cuda: the graph pool every chain graph of the set shares (one
        # stream replays them one at a time) and the stream they are
        # captured on; made at the first capture
        self._graphs = None

    # ---------------------------------------------------------- fused chains
    @staticmethod
    def _chain_key(spec):
        return (spec.signature(),
                tuple(id(o.csr) for h in spec.hops
                      for o in list(h.orients) + [p.orient
                                                  for p in h.probes]))

    def chain_program(self, spec) -> FusedChain:
        self._sweep_epoch()
        key = self._chain_key(spec)
        prog = self._chains.get(key)
        if prog is not None:
            self._chains[key] = self._chains.pop(key)   # LRU touch
        else:
            if len(self._chains) >= _CHAIN_SHAPES:
                victim = next((k for k, v in self._chains.items()
                               if not v.pinned), None)
                # all pinned: evict the coldest anyway (capacity wins)
                self._chains.pop(victim if victim is not None
                                 else next(iter(self._chains)))
            prog = self._chains[key] = FusedChain(self, spec)
        return prog

    def pin_chain(self, spec, pinned: bool = True) -> bool:
        """Protect (or release) an existing chain handle — with its bucketed
        programs — from chain-LRU eviction.  Only handles that already
        exist are pinned: a plan with no executed chain has nothing worth
        protecting."""
        prog = self._chains.get(self._chain_key(spec))
        if prog is None:
            return False
        prog.pinned = bool(pinned)
        return True

    def _graph_pool(self):
        """``(pool, side stream)`` of the set's chain graphs.  A one-node
        graph captured into the pool first stays with the set, so the pool
        stays live while every chain graph in it is dropped and captured
        anew (the allocator shares only a pool some graph still holds)."""
        if self._graphs is None:
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.device(self.device):
                pool = torch.cuda.graph_pool_handle()
                side = torch.cuda.Stream(self.device)
                anchor = torch.cuda.CUDAGraph()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    anchor.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                    held = torch.zeros(1, device=self.device)
                    anchor.capture_end()
                cur.wait_stream(side)
            self._graphs = (pool, side, anchor, held)
        return self._graphs[:2]

    def block_ready(self, arrays):
        self.transfer_stats.sync()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return arrays

    # ------------------------------------------------------------ transfers
    def _stage(self, a: np.ndarray) -> torch.Tensor:
        if a.dtype.kind in "iu":
            if a.size and (a.max() > _I32_MAX or a.min() < _I32_MIN):
                raise ValueError("column exceeds the torch backend's int32 "
                                 "staging envelope")
            a = a.astype(np.int32)
        self.transfer_stats.record("h2d", a.size)
        if a.size:
            self.transfer_stats.sync()    # a copy from pageable memory
        return torch.as_tensor(a).to(self.device)

    def asarray(self, values):
        if isinstance(values, torch.Tensor):
            if values.device != self.device:
                self.transfer_stats.record("h2d", values.numel())
                if values.numel():
                    self.transfer_stats.sync()
                return values.to(self.device)
            return values
        return self._stage(np.asarray(values))

    def _array_to_host(self, a) -> np.ndarray:
        if not isinstance(a, torch.Tensor):
            return np.asarray(a)
        self.transfer_stats.record("d2h", a.numel())
        if a.numel():
            self.transfer_stats.sync()
        h = a.detach().cpu().numpy()
        if h.dtype == np.int32:
            h64 = h.astype(np.int64)
            h64[h64 == _I32_MIN] = _I64_MIN   # missing-prop sentinel widens
            return h64
        if h.dtype == np.float32:
            return h.astype(np.float64)
        # a CPU tensor shares its memory with .numpy(): hand out a copy
        return h.copy() if a.device.type == "cpu" else h

    def _col(self, a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else self.asarray(a)

    # ------------------------------------------------------ array primitives
    def take(self, a, idx):
        if isinstance(a, np.ndarray):
            # host-only column (string literals): gather on the host
            return a[self._array_to_host(idx)]
        return torch.index_select(self._col(a), 0, self._col(idx))

    def mask(self, a, m):
        a, m = self._col(a), self._col(m)
        if m.numel():
            self.transfer_stats.sync()    # the output's size
        return a[m]

    def concat(self, parts: list):
        if not parts:
            return self._z32
        if len(parts) == 1:
            return self._col(parts[0])
        return torch.cat([self._col(p) for p in parts])

    def nonzero(self, m):
        m = self._col(m)
        if m.dtype != torch.bool:
            m = m != 0
        self.kernel_stats.record("dispatch", "nonzero")
        if m.numel():
            self.transfer_stats.sync()    # the output's size
        return torch.nonzero(m).flatten().to(torch.int32)

    def full(self, n: int, value):
        if isinstance(value, (bool, np.bool_)):
            dt = torch.bool
        elif isinstance(value, (int, np.integer)):
            dt = (torch.int32 if _I32_MIN <= int(value) <= _I32_MAX
                  else torch.int64)
        else:
            dt = torch.float64
        return torch.full((int(n),), value, dtype=dt, device=self.device)

    def arange(self, n: int):
        return torch.arange(int(n), dtype=torch.int32, device=self.device)

    def isin(self, a, values):
        vals = np.asarray(list(values), dtype=np.int64)
        # values outside the int32 envelope cannot match any staged column
        vals = vals[(vals <= _I32_MAX) & (vals > _I32_MIN)]
        return torch.isin(self._col(a), self.asarray(vals))

    def searchsorted(self, sorted_arr, values, side: str = "left"):
        s, v = self._col(sorted_arr), self._col(values)
        if s.dtype != v.dtype:
            dt = torch.promote_types(s.dtype, v.dtype)
            s, v = s.to(dt), v.to(dt)
        return torch.searchsorted(s, v, right=side == "right",
                                  out_int32=True)

    def where(self, cond, a, b):
        return torch.where(self._col(cond), self._col(a), self._col(b))

    def lexsort(self, cols: list):
        return torchops.lexsort([self._col(c) for c in cols]).to(torch.int32)

    def distinct_indices(self, key):
        key = self._col(key)
        if key.shape[0] == 0:
            return self._z32
        self.kernel_stats.record("dispatch", "distinct")
        order = torchops.stable_argsort(key)
        sk = key[order]
        flag = torch.ones(sk.shape[0], dtype=torch.bool, device=sk.device)
        flag[1:] = sk[1:] != sk[:-1]
        self.transfer_stats.sync()        # the mask's output size
        # the stable sort puts each key's minimal row first in its run
        return torch.sort(order[flag]).values.to(torch.int32)

    # ------------------------------------------------------ device caches
    def _sweep_epoch(self):
        """A compaction swaps the store's base CSRs: drop what was derived
        from the old base — the property columns keyed by the old epoch and
        every fused-chain handle (its spec holds the old CSRs, which would
        otherwise stay alive, with their device twins, in the chain LRU)."""
        epoch = getattr(self.store, "compaction_epoch", 0)
        if epoch == self._epoch:
            return
        self._epoch = epoch
        self._chains.clear()
        for key in [k for k in self._props if k[2] != epoch]:
            self._props.pop(key, None)

    def _cache_weakly(self, name: str, host, value) -> None:
        """Store ``value`` in the cache ``name`` under ``id(host)``, beside
        a weak reference to ``host``; the entry is dropped when ``host`` is
        collected (under a mutation stream every snapshot builds new delta
        views and overlay columns, and a compaction retires the whole
        base)."""
        getattr(self, name)[id(host)] = (weakref.ref(host), value)
        weakref.finalize(host, _forget, weakref.ref(self), name, id(host))

    @staticmethod
    def _cached(cache: dict, host):
        # the stored host reference guards against address reuse
        ent = cache.get(id(host))
        return ent[1] if ent is not None and ent[0]() is host else None

    # ------------------------------------------------------ property gathers
    def _col_dev(self, host_col: np.ndarray):
        """Device twin of a host overlay column (``MutableGraphStore.
        ext_vertex_prop_column`` / ``overlay_edge_prop_column``), keyed by
        object identity.  The host INT64_MIN missing value is narrowed to
        the in-band int32 one before staging."""
        ent = self._cached(self._cols, host_col)
        if ent is None:
            staged = np.where(host_col == _I64_MIN, _I32_MIN, host_col)
            ent = self._stage(staged)
            self._cache_weakly("_cols", host_col, ent)
        return ent

    def _vprop_dev(self, prop: str):
        """One device column per vertex property over the *base* store,
        indexed by global id (types without the property hold the int32
        missing value), so a property gather is a single device take.
        Keyed by compaction epoch, so a rebuilt base re-stages."""
        self._sweep_epoch()
        key = ("v", prop, self._epoch)
        ent = self._props.get(key)
        if ent is None:
            st = getattr(self.store, "base", self.store)
            col = np.full(st.n_vertices, _I32_MIN, dtype=np.int64)
            for t in st._sorted_types():
                tc = st.v_props.get(t, {}).get(prop)
                if tc is None or tc.shape[0] == 0:
                    continue
                off = st.v_offset[t]
                col[off:off + tc.shape[0]] = tc
            ent = self._props[key] = self._stage(col)
        return ent

    def _eprop_dev(self, prop: str):
        """Per-triple edge-property columns of the *base* store concatenated
        on the device, plus per-triple offsets: ``col[offset[triple_id] +
        pos]``; the base nnz rides along, so overlay positions (``>=``
        it) split off."""
        self._sweep_epoch()
        key = ("e", prop, self._epoch)
        ent = self._props.get(key)
        if ent is None:
            st = getattr(self.store, "base", self.store)
            offsets, parts, off = [], [], 0
            for t in sorted(st.out_csr, key=repr):
                tc = st.e_props.get(t, {}).get(prop)
                n = st.out_csr[t].nnz
                offsets.append(off)
                part = np.full(n, _I32_MIN, dtype=np.int64)
                if tc is not None and tc.shape[0]:
                    part[:tc.shape[0]] = tc
                parts.append(part)
                off += n
            flat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            ent = self._props[key] = (
                self._stage(np.asarray(offsets, dtype=np.int64)),
                self._stage(flat), off)
        return ent

    def vertex_prop(self, ids, prop: str):
        """Gather by global id.  On a mutable store, extension ids (``>=
        base_n_vertices``) read the overlay column.  Each side's index is
        clamped into its column before the gather and the sides are then
        selected with ``where``: ``index_select`` has no clip mode, and an
        out-of-range index raises on the CPU and fires a device-side
        assert on the card."""
        ids = self._col(ids)
        base = self._vprop_dev(prop)
        st = self.store
        bv = getattr(st, "base_n_vertices", None)
        if bv is None or getattr(st, "id_space", bv) <= bv:
            return self.take(base, ids)
        ext = self._col_dev(st.ext_vertex_prop_column(prop))
        out = self.take(base, ids.clamp(max=bv - 1))
        return torch.where(ids < bv, out, self.take(
            ext, (ids - bv).clamp(0, ext.shape[0] - 1)))

    def edge_prop(self, triple_ids, pos, prop: str):
        """``col[offset[triple_id] + pos]`` over the base; on a mutable
        store, positions ``>= nbase`` (overlay edges) read the overlay
        column, with the same clamp-then-``where`` as ``vertex_prop``."""
        pos = self._col(pos)
        offsets, flat, nbase = self._eprop_dev(prop)
        st = self.store
        over = getattr(st, "overlay_edge_slots", 0) > 0
        if flat.shape[0] == 0:
            out = torch.full(pos.shape, _I32_MIN, dtype=torch.int32,
                             device=self.device)
        else:
            at = self.take(offsets, self._col(triple_ids)) + pos
            out = self.take(flat, at.clamp(max=flat.shape[0] - 1)
                            if over else at)
        if over:
            ov = self._col_dev(st.overlay_edge_prop_column(prop))
            out = torch.where(pos < nbase, out, self.take(
                ov, (pos - nbase).clamp(0, ov.shape[0] - 1)))
        return out

    # --------------------------------------------------------------- pattern
    def _csr_dev(self, csr, probe: bool = False):
        """Device twin (int32) of a host CSR — a base CSR or a delta view's
        (``DeltaAdj.csr``) — keyed by object identity; the stored weak
        host reference guards against address reuse, and the entry leaves
        when the CSR is collected.  Returns ``(indptr, indices, pos,
        index)``: ``index`` is the K1 search index (``build_search_index``),
        built on the device at the first ``probe`` of the CSR and kept with
        it; None until then."""
        self._sweep_epoch()
        ent = self._cached(self._dev, csr)
        if ent is None:
            ent = [self._stage(csr.indptr), self._stage(csr.indices),
                   self._stage(csr.pos) if csr.pos is not None else None,
                   None]
            self._cache_weakly("_dev", csr, ent)
        if probe and ent[3] is None:
            ent[3] = build_search_index(ent[1])
        return tuple(ent)

    def scan(self, lo: int, hi: int):
        return torch.arange(int(lo), int(hi), dtype=torch.int32,
                            device=self.device)

    def expand(self, csr, rows_local, max_out=None):
        """Flat row-major CSR gather (the host path's exact rows).  The
        degree sum is read back first, so the blow-up guard raises before
        any output is allocated."""
        rows = self._col(rows_local)
        if rows.shape[0] == 0:
            return self._z32, self._z32, self._z32
        indptr, indices, pos, _ = self._csr_dev(csr)
        self.transfer_stats.sync()
        total = torchops.csr_expand_total(indptr, rows)  # control-plane sync
        if max_out is not None and total > max_out:
            raise RuntimeError(f"intermediate blow-up: expansion would "
                               f"produce {total} rows > cap {max_out}")
        if total > _I32_MAX:
            raise RuntimeError(f"intermediate blow-up: expansion would "
                               f"produce {total} rows (beyond the int32 "
                               f"staging envelope)")
        self.kernel_stats.record("dispatch", "expand")
        if total == 0:
            return self._z32, self._z32, self._z32
        return torchops.csr_expand_flat(indptr, indices, pos, rows, total)

    def intersect(self, csr, rows_local, targets):
        """WCOJ membership probe: one ``wcoj_intersect`` kernel launch per
        call.  The kernel maps hits through ``csr.pos`` and zeroes the edge
        position where nothing was found."""
        rows = self._col(rows_local).to(torch.int32).contiguous()
        tgt = self._col(targets).to(torch.int32).contiguous()
        if rows.shape[0] == 0:
            return (torch.zeros(0, dtype=torch.bool, device=self.device),
                    self._z32)
        indptr, indices, pos, index = self._csr_dev(csr, probe=True)
        self.kernel_stats.record("dispatch", "intersect")
        return wcoj_intersect(indptr, indices, rows, tgt, pos, index)

    # --------------------------------------------------------- relational tail
    def join(self, lkeys, rkeys, max_out=None):
        lk, rk = self._col(lkeys), self._col(rkeys)
        if lk.shape[0] == 0 or rk.shape[0] == 0:
            return self._z32, self._z32
        self.kernel_stats.record("dispatch", "join")
        lorder, rorder, lo, cnt = torchops.sortmerge_bounds(lk, rk)
        self.transfer_stats.sync()
        total = int(cnt.sum())                         # control-plane sync
        if max_out is not None and total > max_out:
            raise RuntimeError(f"intermediate blow-up: join would produce "
                               f"{total} rows > cap {max_out}")
        if total > _I32_MAX:
            raise RuntimeError(f"intermediate blow-up: join would produce "
                               f"{total} rows (beyond the int32 staging "
                               f"envelope)")
        if total == 0:
            return self._z32, self._z32
        return torchops.sortmerge_pairs(lorder, rorder, lo, cnt, total)

    def combine_keys(self, cols: list):
        cols = [self._col(c) for c in cols]
        if len(cols) == 1:
            return cols[0]
        if cols[0].shape[0] == 0:
            return self._z32
        self.kernel_stats.record("dispatch", "lex_ranks")
        return torchops.lex_ranks(cols)

    def group_reduce(self, keys, values):
        """Sorted-run grouping: groups ascend by key; ``first`` is each
        group's minimal original row."""
        keys = self._col(keys)
        if keys.shape[0] == 0:
            return self._z32, {name: self._z32 for name in values}
        bad = [fn for fn, _ in values.values() if fn not in _AGGREGATES]
        if bad:
            raise ValueError(f"unknown aggregate {bad[0]}")
        self.kernel_stats.record("dispatch", "group")
        names = list(values)
        self.transfer_stats.sync()        # the group count, in nonzero
        order, starts = torchops.group_boundaries(keys)
        first, outs = torchops.group_aggregate(
            order, starts, tuple(self._col(values[nm][1]) for nm in names),
            tuple(values[nm][0] for nm in names))
        return first.to(torch.int32), dict(zip(names, outs))


def _forget(ops_ref, name: str, key: int) -> None:
    """Finalizer of a cached host object: drop its entry from the cache
    ``name`` if the operator set is still alive.  It runs before the
    object's memory is freed, so no other object holds ``key`` yet."""
    ops = ops_ref()
    if ops is not None:
        getattr(ops, name).pop(key, None)


# ------------------------------------------------------------ physical rule
# ``fuse_expand_chain`` (with ``_hop_predicates``) is the reference's
# physical rule (``repro/graphdb/jax_backend.py``), its logic copied
# unchanged: the port fuses the chains the reference's rule fuses.

def _hop_predicates(pattern, h: ExpandNode) -> list:
    preds = list(pattern.vertices[h.new_alias].predicates or [])
    for e in h.edges:
        preds.extend(e.predicates or [])
    return preds


def fuse_expand_chain(node: PlanNode, ctx) -> PlanNode:
    """Post-CBO physical rewrite (the ``PhysicalSpec.physical_rules`` hook):
    fuse runs of >= 2 consecutive expansions into one ``ExpandChainNode``.

    With device-resident tables (OperatorSet v2) every hop already stays on
    device; chaining pays twice: the thin frontier carries only the hop
    columns through the per-hop gathers, and the backend runs the whole
    chain as ONE program — a single dispatch with no host sync between
    hops, instead of one per hop (DESIGN.md §8).  A hop fuses when its
    source alias is carried by the chain (or anchors it) and its
    predicates are chain-fusable
    (``core.physical.chain_fusable_predicates``: comparisons/IN-sets over
    carried aliases against literals or parameters — the folded filter
    still runs *at its own hop* inside the program, so intermediates stay
    bounded); other predicates close the chain, keeping their hop on the
    per-hop path.  A trailing expand-and-intersect whose probe edges read
    carried aliases folds in as the chain's final WCOJ step.  Fusion is
    packaging, not planning: ``ExpandChainNode.unfused()`` recovers the
    exact pre-fusion plan, and results are row-identical."""
    pattern = ctx.pattern()
    fused = False

    def rewrite(n: PlanNode) -> PlanNode:
        if isinstance(n, JoinNode):
            return dataclasses.replace(n, left=rewrite(n.left),
                                       right=rewrite(n.right))
        if not isinstance(n, ExpandNode):
            return n
        run = [n]                       # the maximal expand run, bottom-up
        cur = n.child
        while isinstance(cur, ExpandNode):
            run.append(cur)
            cur = cur.child
        run.reverse()                   # execution order
        out = rewrite(cur)
        pending: list[tuple[ExpandNode, str]] = []

        def flush():
            nonlocal out, fused
            if len(pending) >= 2:
                fused = True
                steps = [ChainStep(h.edges[0], frm, h.new_alias,
                                   h.est_frequency, h.est_cost,
                                   intersect_edges=tuple(h.edges[1:]))
                         for h, frm in pending]
                out = ExpandChainNode(out, steps,
                                      est_frequency=steps[-1].est_frequency,
                                      est_cost=steps[-1].est_cost)
            else:
                for h, frm in pending:
                    out = ExpandNode(out, h.new_alias, h.edges,
                                     est_frequency=h.est_frequency,
                                     est_cost=h.est_cost)
            pending.clear()

        def preds_fusable(h, frm):
            va = ({pending[0][1]} if pending else {frm})
            va |= {x.new_alias for x, _ in pending} | {h.new_alias}
            ea = {x.edges[0].alias for x, _ in pending} | \
                 {e.alias for e in h.edges}
            return chain_fusable_predicates(_hop_predicates(pattern, h),
                                            va, ea)

        for h in run:
            frm = h.edges[0].other(h.new_alias) if h.edges else None
            if len(h.edges) == 1:
                fusable = preds_fusable(h, frm)
                tail = False
            else:
                # expand-and-intersect: fold as the chain's final WCOJ step
                # when every probe edge reads a carried alias and each is a
                # pure filter (one orientation: directional, single triple)
                carried = ({pending[0][1]} | {x.new_alias
                                              for x, _ in pending}
                           if pending else set())
                tail = fusable = bool(pending) and frm in carried and all(
                    e.other(h.new_alias) in carried
                    and e.direction != BOTH and len(e.triples) == 1
                    for e in h.edges[1:]) and preds_fusable(h, frm)
            if fusable and not tail and pending:
                carried = {pending[0][1]} | {x.new_alias for x, _ in pending}
                if frm not in carried:
                    # source bound below the current run (e.g. by a join
                    # child): close this chain and anchor a new one here
                    flush()
                    fusable = preds_fusable(h, frm)
            if fusable:
                pending.append((h, frm))
                if tail:                # the wcoj step ends its chain
                    flush()
            else:
                flush()
                out = ExpandNode(out, h.new_alias, h.edges,
                                 est_frequency=h.est_frequency,
                                 est_cost=h.est_cost)
        flush()
        return out

    out = rewrite(node)
    # no run fused: hand back the input so PhysicalRulesPass (and its
    # trace) correctly records the plan as unchanged
    return out if fused else node


# Neutral cost weights, the numpy reference spec's: the port's plans, with
# their chains unfused, equal the reference numpy-spec plans.  Fit them
# from H100 runs before changing.
TORCH_COST = CostParams()
_DESCRIPTION = ("device-resident torch columns; eager torchops primitives + "
                "the hand-written CUDA wcoj_intersect probe; fused expand "
                "chains; sort-merge / sorted-run relational tail")

TORCH_SPEC = register_spec(PhysicalSpec(
    name="torch",
    make_operators=functools.partial(TorchOperators, device="cuda"),
    cost=TORCH_COST,
    description=_DESCRIPTION + " (cuda)",
    physical_rules=(fuse_expand_chain,),
))

_DEVICE_SPECS: dict[str, PhysicalSpec] = {"cuda": TORCH_SPEC}


def torch_spec(device: str | torch.device | None = None) -> PhysicalSpec:
    """The torch spec pinned to ``device`` (None: cuda).  Each device gets
    its own registered name (``torch`` for cuda, ``torch[cpu]`` for the
    CPU).  Raises ``RuntimeError`` for cuda when no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    _require_device(dev)
    spec = _DEVICE_SPECS.get(str(dev))
    if spec is None:
        spec = register_spec(PhysicalSpec(
            name=f"torch[{dev}]",
            make_operators=functools.partial(TorchOperators, device=dev),
            cost=TORCH_COST,
            description=_DESCRIPTION + f" ({dev})",
            physical_rules=(fuse_expand_chain,)))
        _DEVICE_SPECS[str(dev)] = spec
    return spec
