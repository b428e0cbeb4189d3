"""GOpt facade — the paper's full pipeline (Fig. 3):

    Cypher/Gremlin -> unified GIR (GraphIrBuilder) -> type inference -> RBO
    -> CBO -> physical plan -> binding-table engine execution.

``GOpt`` owns the metadata providers (schema + GLogue) and the
**OptimizerPipeline** (DESIGN.md §6): ``optimize`` is a thin driver over a
registered sequence of passes (``pre -> type_inference -> rbo fixpoint ->
cbo -> post_physical``); users register custom passes/rules via
``gopt.pipeline.register(...)`` and backends contribute post-CBO physical
rewrites through ``PhysicalSpec.physical_rules``.  The historical
``type_inference=/rbo=/cbo=`` switches are kept as deprecated shims that
gate the corresponding pipeline phases, so benchmarks can still ablate each
technique exactly like the paper's experiments.

On top of the one-shot pipeline sits the **prepared-query lifecycle**
(DESIGN.md §3): ``prepare(query)`` runs the compile pipeline once and caches
the optimized physical plan keyed by (normalized GIR canonical form,
backend, optimizer flags, pipeline signature, build-time bindings);
``PreparedQuery.execute(params)`` skips straight to the engine with fresh
parameter bindings, and ``execute_many`` runs a whole binding batch through
one vectorized engine pass over the cached plan (``Engine.run_batch``).
``run()`` is sugar over an LRU of prepared queries.
``refresh_stats()`` bumps the statistics epoch, invalidating every cached
plan (stale ``PreparedQuery`` handles keep executing their old plan).
``compile_counters`` meters the pipeline stages so tests (and benchmarks)
can assert what re-ran.

The EXPLAIN/PROFILE surface: ``gopt.explain(query, analyze=...)`` (and
``PreparedQuery.explain``) returns a structured ``ExplainReport`` — per-pass
traces with plan diffs, per-operator estimated cost/cardinality, and actual
row counts when ``analyze=True``.  ``run()`` routes queries prefixed with
``EXPLAIN`` / ``PROFILE`` to the same surface.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import time

from repro_torch.core import ir
from repro_torch.core.cardinality import CardEstimator, Statistics
from repro_torch.core.cbo import low_order_plan, random_plan
from repro_torch.core.glogue import GLogue
from repro_torch.core.parser import parse_cypher
from repro_torch.core.pattern import Pattern
from repro_torch.core.physical import PlanNode
from repro_torch.core.physical_spec import PhysicalSpec, get_spec
from repro_torch.core.pipeline import (VERIFY_MODES, ExplainReport,
                                 OptimizerPipeline, PassContext,
                                 PipelineTrace, build_explain_report,
                                 default_pipeline)
from repro_torch.graphdb.engine import Engine, ExecStats, Table, span_clock
from repro_torch.graphdb.storage import GraphStore

_OPT_KEYS = ("type_inference", "rbo", "cbo", "use_glogue", "use_selectivity",
             "physical_rules", "verify")

_EXPLAIN_RE = re.compile(r"^\s*(EXPLAIN\b|PROFILE\b(\s+SYNC\b)?)",
                         re.IGNORECASE)


def _explain_prefix(query: str):
    """Parse an EXPLAIN / PROFILE / PROFILE SYNC prefix; returns
    (mode | None, stripped query) — mode is 'explain', 'profile', or
    'profile_sync'."""
    m = _EXPLAIN_RE.match(query)
    if not m:
        return None, query
    head = m.group(1).split()[0].lower()
    if head == "profile" and m.group(2):
        head = "profile_sync"
    return head, query[m.end():]


def _collect_value_peeks(plan: ir.LogicalPlan,
                         params: dict | None) -> tuple:
    """Record what a freshly-compiled plan *assumed* about each
    ``prop IN $param`` vertex predicate: the peeked set size when the param
    was bound at prepare time, else None (the estimator's agnostic 0.5)."""
    pattern = plan.pattern()
    if pattern is None:
        return ()
    out = []
    for v in pattern.vertices.values():
        for p in v.predicates:
            if (isinstance(p, ir.InSet) and isinstance(p.values, ir.Param)
                    and isinstance(p.item, ir.Prop)):
                bound = (params or {}).get(p.values.name)
                out.append((p.values.name, p.item.name, frozenset(v.types),
                            None if bound is None else len(bound)))
    return tuple(out)


def _freeze(v):
    """Hashable mirror of a binding value (lists/dicts/sets -> tuples)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(_freeze(x) for x in v))
    return v


@dataclasses.dataclass
class OptimizedQuery:
    logical: ir.LogicalPlan
    physical: PlanNode
    compile_s: float
    invalid: bool = False
    trace: PipelineTrace | None = None


@dataclasses.dataclass
class PreparedQuery:
    """A compiled, reusable query: optimized physical plan + metadata.

    ``execute(params)`` binds late-bound ``ir.Param`` nodes and goes straight
    to the engine — no parse / type inference / RBO / CBO re-runs.  Obtained
    from ``GOpt.prepare``; instances are shared via the plan cache, so treat
    them as immutable."""
    gopt: "GOpt"
    opt: OptimizedQuery
    spec: PhysicalSpec
    cache_key: tuple
    source: str | None = None           # query text, when prepared from text
    executions: int = 0
    # build-time value-peek assumptions, one per ``prop IN $param`` vertex
    # predicate: (param name, prop, vertex types, peeked |S| or None) —
    # checked at bind time by GOpt._maybe_replan (re-optimize on skew)
    peeks: tuple = ()
    opts: dict = dataclasses.field(default_factory=dict)

    @property
    def logical(self) -> ir.LogicalPlan:
        return self.opt.logical

    @property
    def physical(self) -> PlanNode:
        return self.opt.physical

    @property
    def compile_s(self) -> float:
        return self.opt.compile_s

    def declared_params(self) -> frozenset[str]:
        return frozenset(self.opt.logical.declared_params())

    def execute(self, params: dict | None = None,
                **exec_kw) -> tuple[Table, ExecStats]:
        # binding-skew guard: a binding whose IN-set cardinality diverges
        # >10x from the build-time peek invalidates this cache entry and
        # re-plans once against the actual binding
        pq = self.gopt._maybe_replan(self, params)
        if pq is not self:
            return pq.execute(params, **exec_kw)
        self.executions += 1
        return self.gopt.execute(self.opt, params=params,
                                 backend=exec_kw.pop("backend", self.spec),
                                 **exec_kw)

    def execute_many(self, bindings: list[dict | None], batch: bool = True,
                     **exec_kw) -> list[tuple[Table, ExecStats]]:
        """Batch execution: one cached plan, many parameter bindings, one
        engine pass.

        The engine runs the pattern phase **once**: parameter-dependent
        predicates execute as the union of the per-binding filters (the
        bindings stack into a single scan filter), then each binding
        re-applies its exact predicate and runs its own relational tail —
        row-identical to looping ``execute`` per binding, with the
        expansion/join work shared.  ``batch=False`` (or a blow-up of the
        union intermediate under ``max_rows``) falls back to the loop."""
        if batch and len(bindings) > 1 and not self.opt.invalid:
            kw = dict(exec_kw)
            backend = kw.pop("backend", self.spec)
            try:
                out = self.gopt.execute_batch(self.opt, bindings,
                                              backend=backend, **kw)
                self.executions += len(bindings)
                return out
            except RuntimeError as exc:
                # only the union intermediate blowing the row cap falls
                # back to the loop; other engine/XLA failures surface
                if "intermediate blow-up" not in str(exc):
                    raise
                out = [self.execute(b, **exec_kw) for b in bindings]
                for _, st in out:
                    st.fallback("batch_blowup")
                return out
        return [self.execute(b, **exec_kw) for b in bindings]

    def explain(self, params: dict | None = None, analyze: bool = False,
                sync: bool = False, **exec_kw) -> ExplainReport:
        """Structured EXPLAIN of the cached plan (``analyze=True`` also
        executes with ``params`` and reports actual row counts;
        ``sync=True`` — the ``PROFILE SYNC`` mode — blocks on the device
        after every operator so ``OpReport.actual_time_s`` reports true
        device times instead of dispatch times on async backends).  A
        type-inference-INVALID query reports its provably-empty result
        instead of crashing on the missing physical plan."""
        tbl = stats = None
        if analyze and not self.opt.invalid:
            declared = self.declared_params()
            bound = {k: v for k, v in (params or {}).items() if k in declared}
            tbl, stats = self.execute(bound, sync_per_op=sync, **exec_kw)
        delta_fn = getattr(self.gopt.store, "delta_info", None)
        return build_explain_report(self.opt, spec=self.spec,
                                    source=self.source, analyze=analyze,
                                    table=tbl, stats=stats, sync=sync,
                                    delta=delta_fn() if callable(delta_fn)
                                    else None)


class GOpt:
    def __init__(self, store: GraphStore, glogue_k: int = 3,
                 build_glogue: bool = True,
                 backend: str | PhysicalSpec = "torch",
                 plan_cache_size: int = 256,
                 pipeline: OptimizerPipeline | None = None,
                 verify: str | None = None,
                 device: str | None = None,
                 devices: int | None = None):
        self.store = store
        self.schema = store.schema
        if devices is not None and backend != "sharded":
            raise ValueError("devices= requires backend='sharded'")
        if backend == "torch":
            # device pin: each device is its own registered spec ("torch"
            # on cuda, "torch[cpu]") so plan caches and per-store operator
            # caches never mix devices; None means cuda, and raises where
            # there is none
            from repro_torch.graphdb.torch_backend import torch_spec
            self.spec = torch_spec(device)
        elif backend == "sharded":
            # shard-count and device pin: each pair is its own registered
            # spec ("sharded[8]", "sharded[2,cpu]"), for the same reason
            from repro_torch.graphdb.sharded_backend import sharded_spec
            self.spec = sharded_spec(devices, device)
        elif device is not None:
            raise ValueError("device= requires backend='torch' or "
                             "backend='sharded'")
        else:
            self.spec = get_spec(backend)
        self.stats = Statistics(store)
        # GLogue's triangle counts run on this GOpt's own spec and device
        self.glogue = (GLogue(store, k=glogue_k, spec=self.spec)
                       if build_glogue else None)
        # the registered pass sequence driving optimize(); per-instance, so
        # registering a custom pass/rule never leaks across GOpt instances
        self.pipeline = pipeline or default_pipeline()
        if verify is not None:
            # instance-wide default verify mode (per-call override: the
            # verify= option of optimize()/prepare())
            if verify not in VERIFY_MODES:
                raise ValueError(f"unknown verify mode {verify!r}; "
                                 f"modes are {VERIFY_MODES}")
            self.pipeline.verify = verify
        # pipeline-stage meters: how many times each compile stage ran
        self.compile_counters: collections.Counter = collections.Counter()
        self.plan_cache_size = plan_cache_size
        self._plan_cache: collections.OrderedDict = collections.OrderedDict()
        self._text_cache: collections.OrderedDict = collections.OrderedDict()
        self._stats_epoch = 0
        self._replans = 0            # binding-skew re-optimizations
        self.replan_ratio = 10.0     # skew threshold (>10x selectivity drift)

    # ----------------------------------------------------------------- parse
    def parse(self, query: str, params: dict | None = None) -> ir.LogicalPlan:
        self.compile_counters["parse"] += 1
        return parse_cypher(query, self.schema, params)

    # -------------------------------------------------------------- optimize
    def optimize(self, query: str | ir.LogicalPlan,
                 params: dict | None = None,
                 type_inference: bool = True,
                 rbo: bool = True,
                 cbo: bool = True,
                 use_glogue: bool = True,
                 use_selectivity: bool = True,
                 physical_rules: bool = True,
                 verify: str | None = None,
                 backend: str | PhysicalSpec | None = None,
                 pipeline: OptimizerPipeline | None = None) -> OptimizedQuery:
        """Thin driver over the registered ``OptimizerPipeline``.

        The boolean stage switches are deprecated shims kept for the
        paper's ablation benchmarks: they gate the corresponding pipeline
        phases (``type_inference`` the inference pass, ``rbo`` the whole
        rbo fixpoint group, ``cbo`` Algorithm 2 vs the left-deep fallback,
        ``physical_rules`` the backend's post-CBO rewrites).  Prefer
        configuring ``gopt.pipeline`` directly."""
        t0 = time.perf_counter()
        if isinstance(query, str):
            plan = self.parse(query, params)
        else:
            plan = query
            if params:
                for k, v in params.items():
                    plan.params.setdefault(k, v)
        spec = self.spec if backend is None else get_spec(backend)
        ctx = PassContext(
            plan=plan, schema=self.schema, stats=self.stats,
            glogue=self.glogue, spec=spec,
            flags={"type_inference": type_inference, "rbo": rbo, "cbo": cbo,
                   "use_glogue": use_glogue,
                   "use_selectivity": use_selectivity,
                   "physical_rules": physical_rules,
                   "verify": verify},
            counters=self.compile_counters)
        trace = (pipeline or self.pipeline).run(ctx)
        return OptimizedQuery(plan, ctx.physical, time.perf_counter() - t0,
                              invalid=ctx.invalid, trace=trace)

    # --------------------------------------------------------------- prepare
    def prepare(self, query: str | ir.LogicalPlan,
                params: dict | None = None,
                backend: str | PhysicalSpec | None = None,
                **opts) -> PreparedQuery:
        """Compile once, execute many: returns a ``PreparedQuery`` whose
        optimized physical plan is cached keyed by (normalized GIR canonical
        form, backend, optimizer flags, pipeline signature, statistics
        epoch, build-time bindings).

        ``params`` here binds *structural* parameters (hop counts) and
        provides defaults / selectivity hints for value parameters; fresh
        bindings go to ``PreparedQuery.execute(params)``.  Two different
        query strings (or a Cypher string and a Gremlin traversal) that
        lower to the same GIR share one cached plan."""
        unknown = set(opts) - set(_OPT_KEYS)
        if unknown:
            raise TypeError(f"unknown optimizer option(s): {sorted(unknown)}")
        spec = self.spec if backend is None else get_spec(backend)
        text = query if isinstance(query, str) else None
        # the pipeline shape is part of every cache key: registering a pass
        # must never serve plans compiled by a differently-shaped pipeline
        opts_key = (tuple(sorted(opts.items())), self.pipeline.signature())

        # fast path: seen this exact query text before -> skip the parse
        text_key = None
        if text is not None:
            text_key = (text, spec.name, opts_key)
            for consumed, pq in self._text_cache.get(text_key, ()):
                if all((params or {}).get(k) == v for k, v in consumed):
                    self._text_cache.move_to_end(text_key)
                    return pq

        if text is not None:
            plan = self.parse(text, params)
        else:
            plan = query.copy()      # never mutate the caller's plan
            if params:
                for k, v in params.items():
                    plan.params.setdefault(k, v)

        # value parameters stay out of the key: structural params are
        # already reflected in the pattern shape (hence in the canonical
        # form), and value bindings only steer cost estimation ("peeking"),
        # so plans are interchangeable across bindings
        key = (ir.canonical_form(plan), spec.name, opts_key)
        pq = self._plan_cache.get(key)
        if pq is None:
            pq = PreparedQuery(self, self.optimize(plan, backend=spec, **opts),
                               spec, key, source=text, opts=dict(opts))
            pq.peeks = _collect_value_peeks(pq.logical, params)
            # prepared queries are strict: drop value-param bindings so they
            # cannot silently act as execution defaults for a later caller —
            # every referenced param must be bound at execute().  Structural
            # bindings (baked into the pattern) are kept for bookkeeping.
            referenced = pq.logical.referenced_params()
            for k in [k for k in pq.logical.params if k in referenced]:
                del pq.logical.params[k]
            self._plan_cache[key] = pq
            if len(self._plan_cache) > self.plan_cache_size:
                self._plan_cache.popitem(last=False)
        else:
            self._plan_cache.move_to_end(key)

        if text_key is not None:
            # structural bindings consumed at parse time are baked into the
            # pattern; remember them so a later call with different values
            # misses this entry and re-prepares
            consumed = tuple(sorted(
                (k, _freeze(v)) for k, v in
                (pq.logical.hints.get("structural_params") or {}).items()))
            entries = self._text_cache.setdefault(text_key, [])
            entries.append((consumed, pq))
            del entries[:-16]     # cap variants per text (structural params)
            self._text_cache.move_to_end(text_key)
            if len(self._text_cache) > self.plan_cache_size:
                self._text_cache.popitem(last=False)
        return pq

    # ---------------------------------------------------- cache invalidation
    def plan_cache_info(self) -> dict:
        return {"plans": len(self._plan_cache),
                "texts": len(self._text_cache),
                "max": self.plan_cache_size,
                "epoch": self._stats_epoch,
                "replans": self._replans}

    def _maybe_replan(self, pq: PreparedQuery,
                      params: dict | None) -> PreparedQuery:
        """Re-optimize-on-binding-skew: if a binding's IN-set selectivity
        diverges more than ``replan_ratio`` from the cached plan's build-time
        value-peek assumption, invalidate the entry and re-plan once against
        the actual binding.  Returns the (possibly fresh) prepared query."""
        if not pq.peeks or not params or pq.opt.invalid:
            return pq
        skewed = False
        for name, prop, types, assumed in pq.peeks:
            vals = params.get(name)
            if vals is None:
                continue
            try:
                actual = float(len(vals))
            except TypeError:
                continue
            ndv = max(max((self.stats.ndv(t, prop) for t in types),
                          default=1.0), 1.0)
            act_sel = min(max(actual, 1.0) / ndv, 1.0)
            asm_sel = (0.5 if assumed is None
                       else min(max(float(assumed), 1.0) / ndv, 1.0))
            if max(act_sel / asm_sel, asm_sel / act_sel) > self.replan_ratio:
                skewed = True
                break
        if not skewed:
            return pq
        self._plan_cache.pop(pq.cache_key, None)
        for tk in list(self._text_cache):
            kept = [e for e in self._text_cache[tk] if e[1] is not pq]
            if kept:
                self._text_cache[tk][:] = kept
            else:
                del self._text_cache[tk]
        self._replans += 1
        source = pq.source if pq.source is not None else pq.logical
        return self.prepare(source, params=dict(params), backend=pq.spec,
                            **pq.opts)

    def touch_plan(self, key: tuple) -> bool:
        """Mark a cached plan recently-used (LRU touch) without resolving
        it — the QueryServer's hotness loop keeps hot plans' cache entries
        alive even while their requests ride stored ``PreparedQuery``
        handles that never call ``prepare``."""
        if key in self._plan_cache:
            self._plan_cache.move_to_end(key)
            return True
        return False

    def bump_stats_epoch(self) -> int:
        """Invalidate every cached prepared plan (call after the store or
        its statistics change).  Outstanding ``PreparedQuery`` handles keep
        executing their — possibly stale-cost — plan; the next
        ``prepare``/``run`` recompiles against fresh statistics."""
        self._stats_epoch += 1
        self._plan_cache.clear()
        self._text_cache.clear()
        return self._stats_epoch

    def refresh_stats(self, rebuild_glogue: bool = False) -> int:
        """Re-derive ``Statistics`` (NDV caches, counts) from the store and
        bump the epoch; optionally rebuild the GLogue catalogue too."""
        self.stats = Statistics(self.store)
        if rebuild_glogue and self.glogue is not None:
            self.glogue = GLogue(self.store, k=self.glogue.k,
                                 spec=self.spec)
        return self.bump_stats_epoch()

    # --------------------------------------------------------------- explain
    def explain(self, query: str | ir.LogicalPlan,
                params: dict | None = None, analyze: bool = False,
                sync: bool = False,
                backend: str | PhysicalSpec | None = None,
                **kw) -> ExplainReport:
        """Structured EXPLAIN/PROFILE: compile (through the prepared-plan
        cache) and report per-pass traces plus per-operator estimates;
        ``analyze=True`` (or a ``PROFILE`` prefix) also executes with
        ``params`` and reports estimated-vs-actual cardinalities.
        ``sync=True`` (or ``PROFILE SYNC``) syncs the device per operator
        for true per-operator device times."""
        opts = {k: v for k, v in kw.items() if k in _OPT_KEYS}
        exec_kw = {k: v for k, v in kw.items() if k not in _OPT_KEYS}
        if isinstance(query, str):
            mode, query = _explain_prefix(query)
            if mode is not None and mode.startswith("profile"):
                analyze = True
                if mode == "profile_sync":
                    sync = True
        pq = self.prepare(query, params, backend=backend, **opts)
        return pq.explain(params=params, analyze=analyze, sync=sync,
                          **exec_kw)

    # --------------------------------------------------------------- execute
    def execute(self, opt: OptimizedQuery,
                fuse_expand: bool | None = None,
                trim_fields: bool = True,
                max_rows: int = 100_000_000,
                backend: str | PhysicalSpec | None = None,
                params: dict | None = None,
                chain_dispatch: bool = True,
                sync_per_op: bool = False,
                snapshot=None,
                deadline_s: float | None = None,
                stats: ExecStats | None = None
                ) -> tuple[Table, ExecStats]:
        """Run an optimized plan.  ``stats``: a record whose spans the
        caller opened (``run``); by default the run gets its own, under a
        root ``gopt.execute`` span."""
        if opt.invalid:
            return Table.empty(), stats if stats is not None else ExecStats()
        fuse = (opt.logical.hints.get("fuse_expand", True)
                if fuse_expand is None else fuse_expand)
        spec = self.spec if backend is None else get_spec(backend)
        root = None
        if stats is None:
            stats = ExecStats()
            root = stats.open("gopt.execute")
        setup = stats.open("engine.setup")
        eng = Engine(self.store, fuse_expand=fuse, trim_fields=trim_fields,
                     max_rows=max_rows, backend=spec,
                     chain_dispatch=chain_dispatch, sync_per_op=sync_per_op,
                     snapshot=snapshot, deadline_s=deadline_s)
        out = eng.run(opt.logical, opt.physical, params=params, stats=stats,
                      setup=setup)
        if root is not None:
            stats.close(root)
        return out

    def execute_batch(self, opt: OptimizedQuery, bindings: list[dict | None],
                      fuse_expand: bool | None = None,
                      trim_fields: bool = True,
                      max_rows: int = 100_000_000,
                      backend: str | PhysicalSpec | None = None,
                      chain_dispatch: bool = True,
                      snapshot=None,
                      deadline_s: float | None = None
                      ) -> list[tuple[Table, ExecStats]]:
        """Vectorized sibling of ``execute``: one engine pattern pass for a
        whole binding batch (``Engine.run_batch``), with the relational
        tails stacked on a binding-id segment column."""
        if opt.invalid:
            return [(Table.empty(), ExecStats()) for _ in bindings]
        fuse = (opt.logical.hints.get("fuse_expand", True)
                if fuse_expand is None else fuse_expand)
        spec = self.spec if backend is None else get_spec(backend)
        eng = Engine(self.store, fuse_expand=fuse, trim_fields=trim_fields,
                     max_rows=max_rows, backend=spec,
                     chain_dispatch=chain_dispatch, snapshot=snapshot,
                     deadline_s=deadline_s)
        return eng.run_batch(opt.logical, opt.physical, bindings)

    def run(self, query: str | ir.LogicalPlan, params: dict | None = None,
            **kw) -> tuple[Table, ExecStats] | ExplainReport:
        """Prepared-query sugar: resolve the query through the prepared-plan
        LRU, then execute with ``params``.  Repeated runs of one query text
        with fresh bindings compile exactly once.

        A query prefixed with ``EXPLAIN`` (compile only) or ``PROFILE``
        (compile + execute) returns an ``ExplainReport`` instead of a
        result table; a plan parsed from such a query (the parser records
        the prefix as ``hints['explain']``) routes the same way.

        The returned ``ExecStats.spans`` hold one root ``gopt.run`` span,
        from entry to return, around ``plan`` (the prepared-plan lookup,
        which compiles on a miss, and the re-plan on binding skew) and the
        engine's ``engine.setup``, ``pattern``, ``tail`` and ``deliver``."""
        start = span_clock()
        mode = None
        if isinstance(query, str):
            mode, query = _explain_prefix(query)
        elif isinstance(query, ir.LogicalPlan):
            mode = query.hints.get("explain")
        if mode is not None:
            return self.explain(query, params,
                                analyze=mode.startswith("profile"),
                                sync=mode == "profile_sync",
                                backend=kw.pop("backend", None), **kw)
        opts = {k: v for k, v in kw.items() if k in _OPT_KEYS}
        exec_kw = {k: v for k, v in kw.items()
                   if k not in _OPT_KEYS and k != "backend"}
        stats = ExecStats()
        root = stats.open("gopt.run", start)
        span = stats.open("plan")
        pq = self.prepare(query, params, backend=kw.get("backend"), **opts)
        # run() is shared-dict friendly: forward only the bindings this
        # query declares (whichever call populated the cache), so unused
        # keys never trip the strict extra-binding check in execute().  A
        # typo'd name still surfaces — as the real parameter left unbound.
        declared = pq.declared_params()
        bound = {k: v for k, v in (params or {}).items() if k in declared}
        pq = self._maybe_replan(pq, bound)
        stats.close(span)
        out = pq.execute(bound, stats=stats, **exec_kw)
        stats.close(root)
        return out

    # ------------------------------------------------------------- baselines
    def estimator(self, use_glogue: bool = True,
                  use_selectivity: bool = True,
                  params: dict | None = None) -> CardEstimator:
        return CardEstimator(self.stats, self.glogue if use_glogue else None,
                             use_selectivity=use_selectivity, params=params)

    def neo4j_style_plan(self, pattern: Pattern) -> PlanNode:
        """Low-order foil: no type inference assumed done by caller, no
        GLogue, no WCOJ, independence assumption."""
        return low_order_plan(pattern, self.estimator(use_glogue=False),
                              spec=self.spec)

    def random_plans(self, pattern: Pattern, n: int, seed: int = 0):
        import random as _r
        rng = _r.Random(seed)
        return [random_plan(pattern, rng) for _ in range(n)]

    # -------------------------------------------------------------- mutations
    def _mutable(self):
        if not callable(getattr(self.store, "insert_edge", None)):
            raise TypeError(
                "store is frozen; wrap it in repro_torch.graphdb.delta."
                "MutableGraphStore to accept mutations")
        return self.store

    def insert_vertex(self, vtype: str, props: dict | None = None) -> int:
        return self._mutable().insert_vertex(vtype, props)

    def delete_vertex(self, gid: int) -> bool:
        return self._mutable().delete_vertex(gid)

    def insert_edge(self, triple, src: int, dst: int,
                    props: dict | None = None) -> bool:
        return self._mutable().insert_edge(triple, src, dst, props)

    def delete_edge(self, triple, src: int, dst: int) -> bool:
        return self._mutable().delete_edge(triple, src, dst)

    def snapshot(self):
        """Pin the store's current MVCC snapshot (None on a frozen store)."""
        snap_fn = getattr(self.store, "snapshot", None)
        return snap_fn() if callable(snap_fn) else None

    def delta_info(self) -> dict | None:
        fn = getattr(self.store, "delta_info", None)
        return fn() if callable(fn) else None

    def compact(self, rebuild_glogue: bool = True) -> dict:
        """Merge the delta overlay into a rebuilt base CSR, re-derive
        statistics and bump the stats epoch (cached plans re-cost on next
        prepare).  GLogue is rebuilt on this GOpt's own spec: on cuda its
        triangle counts probe the new CSR through the ``wcoj_intersect``
        kernel.  Returns the compaction event dict."""
        event = self._mutable().compact()
        self.refresh_stats(rebuild_glogue=rebuild_glogue)
        return event

    # ----------------------------------------------------------------- serve
    def serve(self, **kw) -> "object":
        """Continuous-batching query service over this GOpt (DESIGN.md §9):
        a ``repro_torch.graphdb.serve.QueryServer`` that coalesces submitted
        ``(query, params)`` requests into ``execute_many`` waves per cached
        plan.  Keyword arguments forward to the ``QueryServer``
        constructor (``max_pending``, ``max_wave``, ``hot_plans``, ...)."""
        from repro_torch.graphdb.serve import QueryServer
        return QueryServer(self, **kw)
