"""QueryServer — continuous batching for prepared graph queries (DESIGN.md §9).

The graph twin of the LM slot scheduler in ``repro_torch.serve.engine``: where the
LM engine coalesces decode steps of whatever requests currently occupy its
slot pool, the QueryServer coalesces *queries that share a cached plan* into
``Engine.run_batch`` waves.  Requests are admitted into per-plan queues
keyed by the canonical plan-cache key (``PreparedQuery.cache_key``); wave
formation takes the queue with the oldest waiting request (FIFO fairness
across plans) and coalesces up to ``max_wave`` requests, rounding the wave
size down to a power of two while the queue still has a remainder — so a
warmed server's recurring wave sizes land on the same pow2 capacity buckets
the backend's compiled programs (fused chains, bucketed tail kernels) are
keyed by, re-hitting the compile cache instead of thrashing it.

Scheduling/latency mechanics:

- **admission control** — the total pending queue is bounded
  (``max_pending``); ``submit`` raises ``ServeOverload`` when full
  (backpressure, counted in ``ServeStats.rejected``).  Parameter bindings
  are validated at admission (host-side), so a malformed request is
  rejected before it ever occupies a wave slot.
- **deadline drop** — a request carrying ``deadline_s`` that expires before
  its wave forms is dropped at formation time (``ServeStats.dropped``),
  never dispatched.
- **overlap** — with ``overlap=True`` waves execute on a single worker
  thread: while wave *k* runs its device program, the main thread admits,
  validates, and forms wave *k+1* (every backend/array call stays on the
  one worker thread; host-side bookkeeping stays on the caller's thread).
- **duplicate suppression** — identical bindings within a wave execute
  once and fan the result out (hot-key traffic makes these common), so a
  wave's device cost scales with its *distinct* bindings.
- **hotness LRU** — per-plan hit counts keep the ``hot_plans`` hottest
  plans pinned: their plan-cache entries are LRU-touched and their fused
  chains' compiled programs are protected from backend cache eviction
  (``OperatorSet.pin_chain``), so a burst of cold plans cannot evict a hot
  plan's warmed programs.
- **ledger scoping** — both backend instrumentation ledgers
  (``TransferStats`` / ``KernelStats``) are reset at each wave start
  (``OperatorSet.reset_ledgers``): one request's PROFILE window can never
  report a neighboring wave's dispatches or transfers.  The ledgers stay
  bounded under sustained traffic because every run releases its holds
  (``physical_spec._Ledger``).

Failure containment (DESIGN.md §13): every wave executes under a
containment boundary.  A failed wave is bisected to isolate the poison
binding (healthy co-batched requests still succeed), transient failures
retry with capped exponential backoff, repeat-offender bindings are
quarantined at admission, and a per-(plan, backend) circuit breaker walks
the graceful-degradation ladder — fused-chain dispatch -> per-hop loop ->
``fallback_spec`` — on persistent failures, with half-open probes to step
back up.  The host rung is opt-in on a device spec: by default
(``fallback_spec="auto"``) a server over a host set falls back to
``numpy`` and one over a card set has no rung 2, so a broken kernel fails
its requests instead of moving their work to the CPU.  A plain
``RuntimeError`` (a kernel build or launch error, a CUDA error) fails its
request at the rung it hit; only structured ``ExecError`` failures and
other exception types walk the ladder.  Failed requests terminate with ``status="failed"`` and a
structured ``ExecError``; under overlap the worker is supervised (a crash
respawns the pool and re-forms the in-flight wave exactly once).  No
admitted request ever ends without a terminal status: done / failed /
dropped / cancelled.

``ServeStats`` is the serving ledger — wave sizes, batch occupancy, queue
delay vs execution time, fallback-to-loop counts, per-wave compile counts,
failure/retry/degradation counters — and surfaces through the existing
EXPLAIN/PROFILE reporting: ``QueryServer.explain(query)`` attaches the
plan's serving summary to the ``ExplainReport`` (rendered as a
``-- serve --`` section).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core.errors import (DeadlineExceeded, ExecError, ParamError,
                               classify_error)
from repro_torch.core.gopt import _freeze
from repro_torch.core.physical_spec import get_spec


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[idx])


class ServeOverload(RuntimeError):
    """Admission rejected: the bounded pending queue is full."""


class ServeQuarantined(RuntimeError):
    """Admission rejected: this exact (plan, binding) pair failed
    permanently ``quarantine_after`` times and is quarantined — resubmitting
    it would poison another wave (counted in ``ServeStats.quarantined``)."""


# the update stream's queue key: writes ride the same admission path and
# FIFO-fair wave formation as reads, on a dedicated queue
_WRITE_KEY = ("__update__",)
_WRITE_KINDS = ("insert_vertex", "insert_edge",
                "delete_vertex", "delete_edge")


@dataclasses.dataclass
class ServeRequest:
    """One admitted query request and its lifecycle record."""
    rid: int
    prepared: object                 # PreparedQuery (None for updates)
    params: dict | None
    arrival_s: float                 # perf_counter-domain arrival time
    deadline_s: float | None = None  # absolute; expired requests are dropped
    status: str = "pending"   # pending | done | dropped | failed | cancelled
    table: object | None = None
    stats: object | None = None      # ExecStats of this request's execution
    error: object | None = None      # structured ExecError when failed
    # worker-supervision marker: set when this request's wave was re-formed
    # after a worker crash — a second crash fails it instead of re-executing
    respawned: bool = False
    start_s: float = 0.0             # wave execution start
    finish_s: float = 0.0
    kind: str = "query"              # query | update
    update: tuple | None = None      # (mutation name, args, kwargs)
    result: object | None = None     # mutation return value (updates)
    # MVCC-lite: the store snapshot pinned at admission — this request
    # answers as-of its admission version no matter when its wave runs
    snapshot: object | None = None
    snap_version: int = -1

    @property
    def queue_delay_s(self) -> float:
        return max(0.0, self.start_s - self.arrival_s)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finish_s - self.arrival_s)


class ServeStats:
    """The serving ledger: wave shapes, latency decomposition, drops."""

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.rejected = 0          # backpressure (ServeOverload)
        self.dropped = 0           # deadline drops (formation + mid-wave)
        self.deduped = 0           # duplicate bindings suppressed in waves
        self.writes = 0            # applied mutations (update stream)
        # containment counters (DESIGN.md §13)
        self.failed = 0            # requests terminated status="failed"
        self.cancelled = 0         # still-queued requests rejected at close()
        self.retries = 0           # transient retry attempts (all waves)
        self.bisections = 0        # failed-wave splits while isolating poison
        self.quarantined = 0       # admissions rejected by quarantine
        self.deadline_aborts = 0   # mid-execution cooperative deadline aborts
        self.worker_respawns = 0   # overlap-worker crashes survived
        self.breaker_trips = 0     # degradation-ladder steps down
        self.breaker_recoveries = 0  # half-open probes that stepped back up
        self.breaker_probes = 0    # half-open probes attempted
        self.waves = 0
        # read waves by the degradation-ladder rung they ran at (the
        # highest rung any of their requests reached): 0 native, 1 per-hop
        # loop, 2 the fallback spec — a host wave on a card shows up here
        self.rung_waves = [0, 0, 0]
        self.wave_sizes: list[int] = []
        # wave size / its pow2 capacity bucket — 1.0 means the wave exactly
        # fills the bucket its compiled programs are keyed by
        self.occupancy: list[float] = []
        self.queue_delay_s: list[float] = []   # per completed request
        self.exec_s: list[float] = []          # per wave
        self.latency_s: list[float] = []       # per completed request
        self.fallbacks: dict[str, int] = {}    # engine fallback counters
        # per-wave compile-event counts from the (wave-scoped) KernelStats
        # window — a warmed server holds these flat at zero
        self.wave_compiles: list[int] = []
        self.wave_chain_compiles: list[int] = []
        self.per_plan: dict = {}               # cache_key -> summary dict

    # ------------------------------------------------------------ recording
    def _plan(self, key) -> dict:
        return self.per_plan.setdefault(key, {
            "waves": 0, "requests": 0, "failed": 0, "queue_delay_s": [],
            "exec_s": [], "fallbacks": {}, "compiles": 0})

    def record_wave(self, key, reqs, bucket: int, exec_s: float,
                    kernels: dict | None):
        self.waves += 1
        self.wave_sizes.append(len(reqs))
        self.occupancy.append(len(reqs) / max(bucket, 1))
        self.exec_s.append(exec_s)
        kernels = kernels or {}
        compiles = sum(v for k, v in kernels.items()
                       if k.startswith("compile:"))
        self.wave_compiles.append(compiles)
        self.wave_chain_compiles.append(kernels.get("compile:fused_chain", 0))
        plan = self._plan(key)
        plan["waves"] += 1
        plan["exec_s"].append(exec_s)
        plan["compiles"] += compiles
        for r in reqs:
            if r.status != "done":
                # failed/dropped mid-wave: terminal accounting happened at
                # marking time; only completions feed the latency ledgers
                continue
            self.completed += 1
            self.queue_delay_s.append(r.queue_delay_s)
            self.latency_s.append(r.latency_s)
            plan["requests"] += 1
            plan["queue_delay_s"].append(r.queue_delay_s)
            for reason, n in (getattr(r.stats, "fallbacks", None) or {}).items():
                self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n
                pf = plan["fallbacks"]
                pf[reason] = pf.get(reason, 0) + n

    def record_failure(self, key):
        self.failed += 1
        self._plan(key)["failed"] += 1

    # ------------------------------------------------------------- summaries
    def summary(self) -> dict:
        n_w = max(self.waves, 1)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "dropped": self.dropped,
            "deduped": self.deduped,
            "writes": self.writes,
            "waves": self.waves,
            "mean_wave_size": sum(self.wave_sizes) / n_w,
            "mean_occupancy": sum(self.occupancy) / n_w,
            "queue_delay_p50_ms": _percentile(self.queue_delay_s, 50) * 1e3,
            "queue_delay_p99_ms": _percentile(self.queue_delay_s, 99) * 1e3,
            "exec_p50_ms": _percentile(self.exec_s, 50) * 1e3,
            "latency_p50_ms": _percentile(self.latency_s, 50) * 1e3,
            "latency_p99_ms": _percentile(self.latency_s, 99) * 1e3,
            "fallbacks": dict(self.fallbacks),
            "compiles_per_wave": list(self.wave_compiles),
            "failed": self.failed,
            "cancelled": self.cancelled,
            "retries": self.retries,
            "bisections": self.bisections,
            "quarantined": self.quarantined,
            "deadline_aborts": self.deadline_aborts,
            "worker_respawns": self.worker_respawns,
            "breaker_trips": self.breaker_trips,
            "breaker_recoveries": self.breaker_recoveries,
            "breaker_probes": self.breaker_probes,
            "rung_waves": list(self.rung_waves),
        }

    def plan_summary(self, key) -> dict:
        """Per-plan serving section for ``ExplainReport.serve``."""
        plan = self.per_plan.get(key)
        if plan is None:
            return {"waves": 0, "requests": 0}
        n_w = max(plan["waves"], 1)
        return {
            "waves": plan["waves"],
            "requests": plan["requests"],
            "failed": plan["failed"],
            "mean_wave_size": round(plan["requests"] / n_w, 2),
            "queue_delay_p50_ms":
                round(_percentile(plan["queue_delay_s"], 50) * 1e3, 3),
            "queue_delay_p99_ms":
                round(_percentile(plan["queue_delay_s"], 99) * 1e3, 3),
            "exec_p50_ms": round(_percentile(plan["exec_s"], 50) * 1e3, 3),
            "fallbacks": dict(plan["fallbacks"]),
            "compiles": plan["compiles"],
        }

    def render(self) -> str:
        s = self.summary()
        lines = [
            f"ServeStats: {s['completed']}/{s['submitted']} completed over "
            f"{s['waves']} waves "
            f"(rejected={s['rejected']}, dropped={s['dropped']}, "
            f"deduped={s['deduped']})",
            f"  wave size mean={s['mean_wave_size']:.1f} "
            f"occupancy={s['mean_occupancy']:.2f}",
            f"  queue delay p50={s['queue_delay_p50_ms']:.2f}ms "
            f"p99={s['queue_delay_p99_ms']:.2f}ms | "
            f"exec p50={s['exec_p50_ms']:.2f}ms",
            f"  latency p50={s['latency_p50_ms']:.2f}ms "
            f"p99={s['latency_p99_ms']:.2f}ms",
            f"  fallbacks={s['fallbacks'] or '{}'} "
            f"compiles/wave={s['compiles_per_wave']}",
            f"  containment: failed={s['failed']} retries={s['retries']} "
            f"bisections={s['bisections']} quarantined={s['quarantined']} "
            f"cancelled={s['cancelled']} deadline_aborts="
            f"{s['deadline_aborts']}",
            f"  breaker: trips={s['breaker_trips']} "
            f"recoveries={s['breaker_recoveries']} "
            f"probes={s['breaker_probes']} "
            f"respawns={s['worker_respawns']} "
            f"waves by rung={s['rung_waves']}",
        ]
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()


class QueryServer:
    """Continuous-batching service over a ``GOpt`` (DESIGN.md §9).

    >>> srv = gopt.serve(max_wave=32)
    >>> reqs = [srv.submit(Q, {"pid": p}) for p in people]
    >>> srv.drain()
    >>> reqs[0].table, reqs[0].stats
    """

    def __init__(self, gopt, backend=None, max_pending: int = 1024,
                 max_wave: int = 64, hot_plans: int = 4,
                 overlap: bool = True, bucket_waves: bool = True,
                 pad_waves: bool | None = None, containment: bool = True,
                 max_retries: int = 2, retry_backoff_s: float = 0.005,
                 quarantine_after: int = 2, breaker_threshold: int = 3,
                 probe_after: int = 2, fallback_spec="auto", **exec_kw):
        self.gopt = gopt
        self.backend = backend
        self.max_pending = max_pending
        self.max_wave = max_wave
        self.hot_plans = hot_plans
        self.bucket_waves = bucket_waves
        # None = auto: pad executed batches to pow2 on compiling backends
        self.pad_waves = pad_waves
        # failure containment (DESIGN.md §13): containment=False restores
        # the uncontained execution path (exceptions escape the wave) — the
        # perf harness's baseline for measuring containment overhead
        self.containment = containment
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_after = quarantine_after
        self.breaker_threshold = breaker_threshold
        self.probe_after = probe_after
        # the degradation ladder's last rung: any backend name/spec, or
        # None for none; "auto" is the numpy host spec when the serving
        # set is itself on the host, and no host rung on a device set
        if fallback_spec == "auto":
            spec = get_spec(backend if backend is not None else gopt.spec)
            fallback_spec = ("numpy" if spec.operators(gopt.store).on_host
                             else None)
        self.fallback_spec = fallback_spec
        self._top_rung = 2 if fallback_spec is not None else 1
        self.exec_kw = exec_kw
        self.stats = ServeStats()
        self._queues: "OrderedDict[tuple, deque[ServeRequest]]" = OrderedDict()
        self._plans: dict = {}            # cache_key -> PreparedQuery
        self._hot: dict = {}              # cache_key -> hit count
        self._samples: dict = {}          # cache_key -> a recent binding
        self._pinned: set = set()         # cache_keys currently pinned
        self._pending = 0
        self._rid = 0
        self._inflight = None             # (future, key, reqs) under overlap
        self._lock = threading.Lock()     # guards the gopt plan-cache LRU
        # admission lock: submit()/submit_update() may be called from many
        # client threads, so queue/pending/rid mutations are serialized
        # against each other and against wave formation; worker-side code
        # never takes it (R3: the worker never touches admission state)
        self._alock = threading.Lock()
        # containment state: (cache_key, frozen binding) -> permanent-failure
        # count (quarantine), cache_key -> circuit-breaker ladder state
        self._offenders: dict = {}
        self._breakers: dict = {}
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="serve-wave")
                      if overlap else None)

    # ------------------------------------------------------------- admission
    def submit(self, query, params: dict | None = None,
               deadline_s: float | None = None,
               arrival_s: float | None = None) -> ServeRequest:
        """Admit one request: resolve the plan through the prepared-plan
        cache, validate its bindings host-side, and enqueue it on its
        plan's queue.  ``deadline_s`` is an absolute ``perf_counter``-domain
        deadline; ``arrival_s`` backdates the arrival (open-loop benchmark
        drivers use the scheduled arrival time so queueing delay is
        measured against the arrival process, not the submit call).
        Raises ``ServeOverload`` when the bounded queue is full,
        ``ServeQuarantined`` for a quarantined (plan, binding) pair, and
        ``ParamError`` on a malformed binding."""
        if hasattr(query, "cache_key") and hasattr(query, "execute_many"):
            pq = query
        else:
            with self._lock:
                pq = self.gopt.prepare(query, backend=self.backend)
        self._validate(pq, params)
        key = pq.cache_key
        # quarantine: a binding that failed permanently quarantine_after
        # times is rejected here, before it can poison another wave
        fails = self._offenders.get((key, _freeze(params or {})), 0)
        if fails >= self.quarantine_after:
            self.stats.quarantined += 1
            raise ServeQuarantined(
                f"binding quarantined after {fails} permanent failures "
                f"on plan {key!r}")
        now = time.perf_counter() if arrival_s is None else arrival_s
        # MVCC-lite: pin the store snapshot *at admission* — the request
        # answers as-of this version even when writes land before its wave
        snap = self.gopt.snapshot()
        with self._alock:
            if self._pending >= self.max_pending:
                self.stats.rejected += 1
                raise ServeOverload(
                    f"pending queue full ({self._pending}/{self.max_pending})")
            self._rid += 1
            req = ServeRequest(self._rid, pq, params, now, deadline_s)
            if snap is not None:
                req.snapshot = snap
                req.snap_version = snap.version
            self._plans[key] = pq
            self._queues.setdefault(key, deque()).append(req)
            self._pending += 1
            self.stats.submitted += 1
        return req

    def submit_update(self, kind: str, *args,
                      deadline_s: float | None = None,
                      arrival_s: float | None = None, **kw) -> ServeRequest:
        """Admit one mutation (``insert_vertex``/``insert_edge``/
        ``delete_vertex``/``delete_edge``) through the same admission path
        as queries: bounded queue, FIFO-fair wave formation.  Updates ride
        a dedicated queue and apply on the worker thread in wave order;
        the mutation's return value lands in ``req.result``.  Reads pinned
        their snapshot at admission, so an update wave never disturbs an
        already-admitted read."""
        if kind not in _WRITE_KINDS:
            raise ValueError(f"unknown update kind {kind!r}; "
                             f"expected one of {_WRITE_KINDS}")
        if not callable(getattr(self.gopt.store, kind, None)):
            raise TypeError("store is frozen; serve mutations require a "
                            "repro_torch.graphdb.delta.MutableGraphStore")
        now = time.perf_counter() if arrival_s is None else arrival_s
        with self._alock:
            if self._pending >= self.max_pending:
                self.stats.rejected += 1
                raise ServeOverload(
                    f"pending queue full ({self._pending}/{self.max_pending})")
            self._rid += 1
            req = ServeRequest(self._rid, None, None, now, deadline_s,
                               kind="update", update=(kind, args, kw))
            self._queues.setdefault(_WRITE_KEY, deque()).append(req)
            self._pending += 1
            self.stats.submitted += 1
        return req

    @staticmethod
    def _validate(pq, params: dict | None):
        """Host-side admission validation (mirrors ``Engine.bind_params``'s
        strict checks) so malformed requests never occupy a wave slot."""
        referenced = pq.logical.referenced_params()
        declared = referenced | set(pq.logical.params)
        provided = set(params or {})
        extra = provided - declared
        if extra:
            raise ParamError("binding names no declared parameter",
                             extra=extra, declared=declared)
        missing = referenced - set(pq.logical.params) - provided
        if missing:
            raise ParamError("unbound parameter(s)", missing=missing,
                             declared=declared)

    @property
    def pending(self) -> int:
        return self._pending

    # -------------------------------------------------------- wave formation
    def _form_wave(self, now: float):
        """Pick the queue with the oldest waiting head (FIFO fairness
        across plans), drop expired requests, and coalesce a wave.  The
        wave size rounds down to a power of two while the queue holds a
        remainder, so recurring wave sizes re-hit the backend's pow2-
        bucketed compile caches; a draining wave takes everything left.
        Runs under the admission lock: formation races with concurrent
        client submits, never with the worker."""
        with self._alock:
            return self._form_wave_locked(now)

    def _form_wave_locked(self, now: float):
        while True:
            key = None
            oldest = None
            for k, q in self._queues.items():
                if q and (oldest is None or q[0].arrival_s < oldest):
                    oldest = q[0].arrival_s
                    key = k
            if key is None:
                return None
            q = self._queues[key]
            reqs: list[ServeRequest] = []
            # snapshot-homogeneous waves: one wave executes against ONE
            # pinned snapshot, so coalescing stops at the first version
            # boundary in the queue (update waves apply in queue order and
            # never split)
            span = len(q)
            if key != _WRITE_KEY:
                span = 1
                while span < len(q) and \
                        q[span].snap_version == q[0].snap_version:
                    span += 1
            size = min(span, self.max_wave)
            if self.bucket_waves and size < span:
                size = _pow2_floor(size)
            popped = 0
            while q and len(reqs) < size and popped < span:
                r = q.popleft()
                popped += 1
                self._pending -= 1
                if r.deadline_s is not None and now > r.deadline_s:
                    r.status = "dropped"
                    r.finish_s = now
                    self.stats.dropped += 1
                    continue
                reqs.append(r)
            if not q:
                del self._queues[key]
            if reqs:
                return key, reqs
            # the whole wave expired: re-form from the remaining queues

    # -------------------------------------------------------------- execution
    def _run_wave(self, key, reqs: list[ServeRequest]):
        """Execute one wave (single worker thread under overlap: every
        backend call for every wave runs here, serialized)."""
        if key == _WRITE_KEY:
            self._run_write_wave(reqs)
            return
        pq = reqs[0].prepared
        ops = pq.spec.operators(self.gopt.store)
        # wave-scoped ledgers: no bleed across waves; the hold keeps the
        # wave's dispatches while each run releases its own
        ops.reset_ledgers()
        kmark = ops.kernel_stats.hold()
        start = time.perf_counter()
        for r in reqs:
            r.start_s = start
        self.stats.deduped += \
            len(reqs) - len({_freeze(r.params or {}) for r in reqs})
        exec_kw = dict(self.exec_kw)
        if reqs[0].snapshot is not None:
            # the wave is snapshot-homogeneous by formation; execute the
            # whole batch against the wave's pinned snapshot
            exec_kw["snapshot"] = reqs[0].snapshot
        self._samples[key] = reqs[0].params
        try:
            if not self.containment:
                # uncontained (legacy) path: one failure kills the whole
                # wave and escapes to the caller — the perf baseline
                self._exec_group(pq, reqs, exec_kw, 0)
                self.stats.rung_waves[0] += 1
            else:
                level, probe = self._breaker_pick(key)
                outcome = {"level_failures": 0, "escalated_to": None}
                self._contained_exec(key, pq, reqs, exec_kw, level,
                                     self.max_retries, outcome)
                self._breaker_report(key, level, probe, outcome)
                self.stats.rung_waves[max(level,
                                          outcome["escalated_to"] or 0)] += 1
            self.stats.record_wave(key, reqs, _pow2(len(reqs)),
                                   time.perf_counter() - start,
                                   ops.kernel_stats.summary(kmark))
        finally:
            ops.kernel_stats.release(kmark)
        self._update_hotness(key, len(reqs))

    def _level_kw(self, exec_kw: dict, level: int) -> dict:
        """Execution kwargs for one degradation-ladder rung: 0 = native
        (fused chains and all), 1 = per-hop loop (``chain_dispatch=False``),
        2 = the ``fallback_spec`` backend (same physical plan; chain nodes
        run on its per-hop loop)."""
        kw = dict(exec_kw)
        if level >= 1:
            kw["chain_dispatch"] = False
        if level >= 2:
            kw["backend"] = self.fallback_spec
        return kw

    def _exec_group(self, pq, reqs: list[ServeRequest], exec_kw: dict,
                    level: int):
        """Execute a (sub)wave at one ladder rung, with duplicate
        suppression and pow2 padding; marks every request done on success.
        Any failure raises to the containment layer.  When every request
        carries a deadline, their max plumbs down as the engine's
        cooperative mid-execution deadline (the wave is abandoned only once
        *all* its deadlines have expired)."""
        exec_kw = self._level_kw(exec_kw, level)
        deadlines = [r.deadline_s for r in reqs]
        if all(d is not None for d in deadlines):
            exec_kw["deadline_s"] = max(deadlines)
        # duplicate suppression: identical bindings in one wave execute
        # once and fan the result out (hot-key traffic makes these common);
        # duplicate requests share the execution's Table and ExecStats
        uniq: dict = {}
        bindings: list = []
        slot = []
        for r in reqs:
            k = _freeze(r.params or {})
            if k not in uniq:
                uniq[k] = len(bindings)
                bindings.append(r.params)
            slot.append(uniq[k])
        if len(bindings) == 1:
            results = [pq.execute(bindings[0], **exec_kw)]
        else:
            # on compiling backends, pad the executed binding list up to
            # its pow2 bucket with a duplicate binding: the union pattern
            # pass is unchanged (duplicate predicate values collapse), and
            # every wave presents the stacked tail with one of a handful
            # of stable batch shapes instead of a fresh trace per size
            pad = (self.pad_waves if self.pad_waves is not None
                   else pq.spec.operators(self.gopt.store).compiled)
            if pad and self.bucket_waves:
                bindings = bindings + \
                    [bindings[0]] * (_pow2(len(bindings)) - len(bindings))
            results = pq.execute_many(bindings, batch=True, **exec_kw)
        finish = time.perf_counter()
        for r, j in zip(reqs, slot):
            r.table, r.stats = results[j]
            r.status = "done"
            r.finish_s = finish

    def _contained_exec(self, key, pq, reqs: list[ServeRequest],
                        exec_kw: dict, level: int, retries_left: int,
                        outcome: dict):
        """The wave containment boundary (DESIGN.md §13.2): execute a
        (sub)group, retrying transients with capped exponential backoff,
        bisecting multi-request groups to isolate poison bindings, and
        walking single failures up the degradation ladder before declaring
        them failed.  Every request leaves with a terminal status."""
        try:
            self._exec_group(pq, reqs, exec_kw, level)
            return
        except DeadlineExceeded:
            # deadline_s was max() over the group: every deadline expired
            self._mark_deadline(reqs)
            return
        except Exception as exc:
            if classify_error(exc) == "transient" and retries_left > 0:
                self.stats.retries += 1
                time.sleep(self.retry_backoff_s *
                           (2 ** (self.max_retries - retries_left)))
                return self._contained_exec(key, pq, reqs, exec_kw, level,
                                            retries_left - 1, outcome)
            outcome["level_failures"] += 1
            if len(reqs) > 1:
                # bisect: isolate the poison binding so healthy co-batched
                # requests still succeed
                self.stats.bisections += 1
                mid = len(reqs) // 2
                self._contained_exec(key, pq, reqs[:mid], exec_kw, level,
                                     self.max_retries, outcome)
                self._contained_exec(key, pq, reqs[mid:], exec_kw, level,
                                     self.max_retries, outcome)
                return
            if isinstance(exc, RuntimeError) and \
                    not isinstance(exc, ExecError):
                # a kernel build/launch or CUDA error: the card is at
                # fault, and no other rung may hide it
                self._mark_failed(key, reqs[0], exc)
                return
            # single request: walk the remaining ladder rungs — a failure
            # that clears at a higher rung is a backend fault (the breaker
            # trips there); one that survives the last rung is poison
            for rung in range(level + 1, self._top_rung + 1):
                try:
                    self._exec_group(pq, reqs, exec_kw, rung)
                    prev = outcome["escalated_to"]
                    outcome["escalated_to"] = (rung if prev is None
                                               else max(prev, rung))
                    return
                except DeadlineExceeded:
                    self._mark_deadline(reqs)
                    return
                except Exception as exc2:
                    exc = exc2
            self._mark_failed(key, reqs[0], exc)

    def _mark_deadline(self, reqs: list[ServeRequest]):
        """Terminal accounting for a cooperative mid-execution deadline
        abort: the whole (sub)group's deadlines expired."""
        now = time.perf_counter()
        for r in reqs:
            r.status = "dropped"
            r.finish_s = now
        self.stats.dropped += len(reqs)
        self.stats.deadline_aborts += len(reqs)

    def _mark_failed(self, key, req: ServeRequest, exc: BaseException,
                     offender: bool = True):
        """Terminal accounting for one failed request: structured
        ``ExecError`` with plan context, ``status="failed"``, offender
        bookkeeping for quarantine (skipped for worker crashes, which are
        not binding-attributable)."""
        if isinstance(exc, ExecError):
            err = exc
            if err.plan is None:
                err.plan = key
        else:
            err = ExecError(str(exc) or type(exc).__name__,
                            kind=classify_error(exc), plan=key, cause=exc)
        req.error = err
        req.status = "failed"
        req.finish_s = time.perf_counter()
        self.stats.record_failure(key)
        if offender and err.kind != "transient":
            fk = (key, _freeze(req.params or {}))
            self._offenders[fk] = self._offenders.get(fk, 0) + 1

    # ------------------------------------------------------- circuit breaker
    def _breaker(self, key) -> dict:
        b = self._breakers.get(key)
        if b is None:
            b = self._breakers[key] = {
                "level": 0, "fail_streak": 0, "ok_streak": 0,
                "trips": 0, "recoveries": 0, "probes": 0}
        return b

    def _breaker_pick(self, key) -> tuple[int, bool]:
        """The ladder rung this wave executes at.  A degraded plan that has
        been clean for ``probe_after`` waves half-opens: the next wave
        probes one rung up — success recovers, failure stays degraded."""
        b = self._breaker(key)
        if b["level"] > 0 and b["ok_streak"] >= self.probe_after:
            b["probes"] += 1
            b["ok_streak"] = 0
            self.stats.breaker_probes += 1
            return b["level"] - 1, True
        return b["level"], False

    def _breaker_report(self, key, level_used: int, probe: bool,
                        outcome: dict):
        """Feed one wave's containment outcome into the plan's breaker."""
        b = self._breaker(key)
        esc = outcome["escalated_to"]
        if esc is not None and esc > b["level"]:
            # evidence-based trip: a request failed at this rung but
            # succeeded higher up — the rung itself is faulty for this plan
            b["level"] = esc
            b["trips"] += 1
            b["fail_streak"] = 0
            b["ok_streak"] = 0
            self.stats.breaker_trips += 1
            return
        if outcome["level_failures"] == 0:
            if probe:
                b["level"] = level_used          # half-open probe succeeded
                b["recoveries"] += 1
                b["ok_streak"] = 0
                self.stats.breaker_recoveries += 1
            else:
                b["ok_streak"] += 1
                b["fail_streak"] = 0
            return
        if probe:
            b["ok_streak"] = 0                   # failed probe: stay degraded
            return
        b["fail_streak"] += 1
        b["ok_streak"] = 0
        if (b["fail_streak"] >= self.breaker_threshold
                and b["level"] < self._top_rung):
            # streak-based trip: persistent failures with no higher-rung
            # success signal (e.g. exhausted transients) step down one rung
            b["level"] += 1
            b["trips"] += 1
            b["fail_streak"] = 0
            self.stats.breaker_trips += 1

    def _run_write_wave(self, reqs: list[ServeRequest]):
        """Apply one update wave in queue order on the worker thread (the
        single writer under overlap; admitted readers hold their own
        immutable snapshots, so writers never block readers).  Mutations
        are contained per request — one bad mutation fails alone."""
        store = self.gopt.store
        start = time.perf_counter()
        applied = 0
        for r in reqs:
            r.start_s = start
            kind, args, kw = r.update
            try:
                r.result = getattr(store, kind)(*args, **kw)
                r.status = "done"
                applied += 1
            except Exception as exc:
                self._mark_failed(_WRITE_KEY, r, exc, offender=False)
        finish = time.perf_counter()
        for r in reqs:
            if r.status == "done":
                r.finish_s = finish
        self.stats.writes += applied
        self.stats.record_wave(_WRITE_KEY, reqs, len(reqs),
                               finish - start, None)

    # --------------------------------------------------------------- hotness
    def _update_hotness(self, key, hits: int):
        """Decayed per-plan hit counts drive two protections for the
        hottest ``hot_plans`` plans: their plan-cache entries stay at the
        LRU head, and their fused chains' compiled programs are pinned
        against backend cache eviction."""
        self._hot[key] = self._hot.get(key, 0) + hits
        with self._lock:
            self.gopt.touch_plan(key)
        hot = set(sorted(self._hot, key=self._hot.get,
                         reverse=True)[:self.hot_plans])
        for k in list(self._pinned - hot):
            if self._set_pinned(k, False):
                self._pinned.discard(k)
        for k in hot - self._pinned:
            if self._set_pinned(k, True):
                self._pinned.add(k)

    def _set_pinned(self, key, pinned: bool) -> bool:
        pq = self._plans.get(key)
        if pq is None:
            return False
        ops = self.gopt.store.__dict__.get(
            "_physical_ops_cache", {}).get(pq.spec.name)
        if ops is None:
            return False
        any_pin = False
        for spec in self._chain_specs(pq, ops):
            any_pin = ops.pin_chain(spec, pinned) or any_pin
        # claim the slot even when the plan has no (executed) chains, so
        # the hot set is stable across waves
        return True

    def _chain_specs(self, pq, ops):
        """Chain specs the engine memoized on this plan's chain nodes for
        the current (store, backend) — the handles worth pinning."""
        from repro_torch.core.physical import ExpandChainNode, plan_children
        store = self.gopt.store
        want = (id(store), getattr(store, "compaction_epoch", 0), ops.name)
        specs = []

        def walk(n):
            if n is None:
                return
            if isinstance(n, ExpandChainNode):
                cached = n.__dict__.get("_chain_spec")
                if cached is not None and cached[0] == want \
                        and cached[1] is not None:
                    specs.append(cached[1])
            for c in plan_children(n):
                walk(c)

        walk(pq.physical)
        return specs

    # ------------------------------------------------------------ scheduling
    def step(self) -> list[ServeRequest]:
        """Form and dispatch ONE wave.  Under overlap the new wave starts
        on the worker while this thread returns the *previous* wave's
        completed requests (admission of the next wave overlaps device
        execution of the current one); without overlap the wave runs
        inline.  Returns ``[]`` when nothing completed this step."""
        wave = self._form_wave(time.perf_counter())
        if wave is None:
            return self.flush()
        key, reqs = wave
        if self._pool is None:
            try:
                self._run_wave(key, reqs)
            except Exception as exc:
                # containment bug or uncontained mode: no request may be
                # left in limbo — fail whatever is still pending
                self._fail_crashed(key, reqs, exc)
                if not self.containment:
                    raise
            return reqs
        prev = self._inflight
        self._inflight = (self._pool.submit(self._run_wave, key, reqs),
                          key, reqs)
        if prev is None:
            return []
        return self._join_wave(prev)

    def flush(self) -> list[ServeRequest]:
        """Join the in-flight wave (if any) and return its requests."""
        if self._inflight is None:
            return []
        prev = self._inflight
        self._inflight = None
        return self._join_wave(prev)

    def _join_wave(self, inflight) -> list[ServeRequest]:
        """Join one dispatched wave, supervising the overlap worker.  An
        exception escaping ``_run_wave`` is a worker crash: the pool is
        respawned and the crashed wave's still-pending requests re-formed
        exactly once on the new worker (a second crash fails them)."""
        fut, key, reqs = inflight
        try:
            fut.result()
            return reqs
        except Exception as exc:
            self.stats.worker_respawns += 1
            old, self._pool = self._pool, None
            # drain the old pool BEFORE spawning its replacement: the next
            # wave may already be queued on it, and the single-worker
            # serialization contract (one backend call stream) must hold
            old.shutdown(wait=True)
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-wave")
            live = [r for r in reqs if r.status == "pending"]
            if not live:
                return reqs
            if any(r.respawned for r in live):
                # already re-formed once — a repeat crash is terminal
                self._fail_crashed(key, live, exc)
                return reqs
            for r in live:
                r.respawned = True
            retry = self._pool.submit(self._run_wave, key, live)
            try:
                retry.result()
            except Exception as exc2:
                self._fail_crashed(key, live, exc2)
            return reqs

    def _fail_crashed(self, key, reqs: list[ServeRequest],
                      exc: BaseException):
        """Terminal accounting for a wave whose worker crashed: every
        still-pending request fails with the crash as cause (crashes are
        not binding-attributable, so no offender bookkeeping)."""
        for r in reqs:
            if r.status == "pending":
                self._mark_failed(key, r, exc, offender=False)

    def drain(self, max_waves: int | None = None) -> list[ServeRequest]:
        """Serve until every queued request completed (or ``max_waves``
        waves dispatched); returns the completed requests in completion
        order."""
        done: list[ServeRequest] = []
        waves = 0
        while self._queues and (max_waves is None or waves < max_waves):
            done.extend(self.step())
            waves += 1
        done.extend(self.flush())
        return done

    # ------------------------------------------------------------ compaction
    def compact(self, warm: bool = True) -> dict:
        """Quiesce, merge the delta overlay into a rebuilt base CSR, and
        bump the stats epoch (``GOpt.compact`` — every cached plan re-costs
        against post-compaction statistics on its next prepare).  With
        ``warm=True`` the hottest plans are re-prepared, warmed once against
        the rebuilt CSR (paying their chain compiles here, not in a serving
        wave), and their fused chains re-pinned — so a warmed server records
        zero chain compiles in post-compaction waves."""
        self.drain()
        event = dict(self.gopt.compact())
        self._pinned.clear()              # old-epoch chain specs are stale
        repinned = 0
        warm_skips = 0
        if warm:
            hot = sorted(self._hot, key=self._hot.get,
                         reverse=True)[:self.hot_plans]
            for key in hot:
                old = self._plans.get(key)
                if old is None or old.source is None:
                    continue
                with self._lock:
                    pq = self.gopt.prepare(old.source, backend=self.backend,
                                           **old.opts)
                self._plans[pq.cache_key] = pq
                try:
                    pq.execute(self._samples.get(key), **self.exec_kw)
                except ParamError:
                    # the remembered sample doesn't bind this plan (e.g.
                    # params cleared): skip the warm, count it, don't pin —
                    # anything else is a real failure and must surface
                    warm_skips += 1
                    continue
                if self._set_pinned(pq.cache_key, True):
                    self._pinned.add(pq.cache_key)
                    repinned += 1
        event["repinned_plans"] = repinned
        event["warm_skips"] = warm_skips
        return event

    # --------------------------------------------------------------- explain
    def explain(self, query, params: dict | None = None,
                analyze: bool = False, **kw):
        """EXPLAIN/PROFILE through the server: the standard
        ``ExplainReport`` with this plan's serving ledger attached
        (``report.serve``, rendered as a ``-- serve --`` section)."""
        with self._lock:
            pq = self.gopt.prepare(query, backend=self.backend)
        report = pq.explain(params=params, analyze=analyze, **kw)
        report.serve = self.stats.plan_summary(pq.cache_key)
        b = self._breakers.get(pq.cache_key)
        if b is not None:
            report.serve["breaker"] = dict(b)
        return report

    # ------------------------------------------------------------- lifecycle
    def close(self):
        """Join the in-flight wave, cancel everything still queued (each
        with ``status="cancelled"``), and shut the worker down.  After
        close, no admitted request is in limbo."""
        self.flush()
        now = time.perf_counter()
        with self._alock:
            for q in self._queues.values():
                for r in q:
                    r.status = "cancelled"
                    r.finish_s = now
                    self.stats.cancelled += 1
                    self._pending -= 1
            self._queues.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc):
        self.close()
