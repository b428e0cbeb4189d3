"""OptimizerPipeline — the registrable pass/rule API of the optimizer
(paper §3: "extensive heuristic rules ... automatic type inference ... and
cost-based optimization" composed as interchangeable pieces; DESIGN.md §6).

PR 1 made the backends pluggable (PhysicalSpec) and PR 2 the frontends
(GraphIrBuilder); this module makes the layer between them pluggable too.
``GOpt.optimize`` is now a thin driver over an ``OptimizerPipeline``: an
ordered sequence of registered ``Pass`` objects grouped into phases

    pre -> type_inference -> rbo (fixpoint group) -> cbo -> post_physical

Each pass sees a ``PassContext`` (the logical plan, metadata providers, the
active backend spec, and the optimizer flags) and records a ``PassTrace``
(wall time, changed flag, rule hit counts, plan-snapshot diffs).  The
``rbo`` phase is special: its passes are run together to a fixpoint, like
the old HepPlanner driver, so heuristic rules registered by users interleave
with the built-ins.  Backends participate through the
``PhysicalSpec.physical_rules`` hook: post-CBO rewrites of the physical
plan, run in the ``post_physical`` phase (e.g. the jax backend's
expand-chain fusion).

On top of the per-pass traces sits the EXPLAIN/PROFILE surface: a
structured ``ExplainReport`` (per-pass traces and diffs, per-operator
estimated cost/cardinality, actual row counts under ``analyze=True``) with
a text renderer, exposed as ``GOpt.explain`` / ``PreparedQuery.explain``
and the ``EXPLAIN`` / ``PROFILE`` query prefixes in the Cypher parser.
"""
from __future__ import annotations

import collections
import dataclasses
import difflib
import time
from typing import Any

from repro_torch.core import ir
from repro_torch.core.cardinality import CardEstimator, Statistics
from repro_torch.core.cbo import GraphOptimizer, annotate_estimates
from repro_torch.core.errors import PipelineError, PlanInvariantError
from repro_torch.core.glogue import GLogue
from repro_torch.core.pattern import expand_path_edges
from repro_torch.core.physical import (ExpandChainNode, ExpandNode, JoinNode,
                                 PlanNode, ScanNode,
                                 default_left_deep_plan, describe_node,
                                 plan_children, plan_operators,
                                 plan_signature)
from repro_torch.core.physical_spec import PhysicalSpec
from repro_torch.core.rules import DEFAULT_RULES, EXTENDED_RULES, Rule
from repro_torch.core.schema import GraphSchema
from repro_torch.core.type_inference import INVALID, infer_types
from repro_torch.core.verify import PlanVerifier, VerifyReport

PHASES = ("pre", "type_inference", "rbo", "cbo", "post_physical")

# static-verification modes (DESIGN.md §12): "cached" verifies the pipeline
# output once per canonical plan form; "always" re-verifies after EVERY
# registered pass so an invalid rewrite raises PlanInvariantError naming it
VERIFY_MODES = ("off", "cached", "always")

# message rendered for a query type inference proved unsatisfiable
UNSAT_MESSAGE = "empty result (type inference proved pattern unsatisfiable)"


# --------------------------------------------------------------------------
# Context and traces
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PassContext:
    """Everything a pass may read or rewrite.

    Passes mutate ``plan`` (logical) and ``physical`` in place / by
    replacement; ``invalid=True`` short-circuits the remaining phases (the
    query provably returns no rows).  ``estimator`` is published by the CBO
    pass so later passes (and EXPLAIN) share its memoized cardinalities."""
    plan: ir.LogicalPlan
    schema: GraphSchema
    stats: Statistics
    glogue: GLogue | None
    spec: PhysicalSpec
    flags: dict
    counters: Any                        # collections.Counter
    physical: PlanNode | None = None
    invalid: bool = False
    estimator: CardEstimator | None = None

    def pattern(self):
        return self.plan.pattern()


@dataclasses.dataclass
class PassTrace:
    """What one registered pass did during one ``optimize`` run."""
    name: str
    phase: str
    wall_s: float = 0.0
    changed: bool = False
    hits: int = 0                        # fixpoint iterations that changed
    skipped: str | None = None           # reason, when the pass did not run
    diff: list[str] = dataclasses.field(default_factory=list)

    def render(self) -> str:
        if self.skipped:
            return (f"[{self.phase:<13}] {self.name:<24} "
                    f"skipped ({self.skipped})")
        state = f"hits={self.hits}" if self.changed else "no-op"
        return (f"[{self.phase:<13}] {self.name:<24} "
                f"{self.wall_s * 1e3:7.2f}ms  {state}")


@dataclasses.dataclass
class PipelineTrace:
    passes: list[PassTrace]
    wall_s: float = 0.0
    invalid: bool = False
    # PlanVerifier report of the pipeline output (verify="cached"/"always";
    # None when verification was off) — EXPLAIN's "-- verify --" section
    verify: VerifyReport | None = None

    def by_name(self, name: str) -> PassTrace | None:
        for t in self.passes:
            if t.name == name:
                return t
        return None

    def render_lines(self, diffs: bool = False) -> list[str]:
        lines = [t.render() for t in self.passes]
        if diffs:
            for t in self.passes:
                if t.diff:
                    lines.append(f"-- {t.name} plan diff --")
                    lines.extend("  " + d for d in t.diff)
        return lines


def _snapshot(ctx: PassContext) -> list[str]:
    lines = ctx.plan.snapshot()
    if ctx.physical is not None:
        lines.append("PHYSICAL[" + plan_signature(ctx.physical) + "]")
    return lines


def _diff(before: list[str], after: list[str]) -> list[str]:
    if before == after:
        return []
    out = difflib.unified_diff(before, after, lineterm="", n=0)
    return [l for l in out if l[:1] in "+-" and l[:3] not in ("+++", "---")]


# --------------------------------------------------------------------------
# The Pass protocol and the pipeline driver
# --------------------------------------------------------------------------


class Pass:
    """One registered unit of optimizer work.

    Subclasses set ``name``/``phase`` and implement ``run(ctx) -> bool``
    (the changed flag).  ``skip(ctx)`` may return a human-readable reason
    to leave the pass out of a run (flag gating); the trace records it."""

    name = "pass"
    phase = "pre"

    def skip(self, ctx: PassContext) -> str | None:
        return None

    def run(self, ctx: PassContext) -> bool:
        raise NotImplementedError


class OptimizerPipeline:
    """Ordered, phase-grouped pass registry + driver.

    Registration keeps passes sorted by phase (the order of ``PHASES``);
    within a phase, insertion order — or ``before=``/``after=`` an existing
    pass name.  ``run`` executes phases in order, running the ``rbo`` phase
    as a fixpoint group, and returns one ``PassTrace`` per pass."""

    MAX_RBO_ITERS = 10
    # memoized clean VerifyReports, keyed by canonical plan form (+ backend
    # + physical signature): verify="cached" pays the checker once per
    # distinct plan shape, like the prepared-plan cache pays the optimizer
    VERIFY_MEMO_SIZE = 512

    def __init__(self, passes: tuple[Pass, ...] = (),
                 capture_diffs: bool = True, verify: str = "off"):
        self._passes: list[Pass] = []
        # before/after canonical-form snapshots feed the PassTrace diffs
        # that EXPLAIN renders; measured at a few percent of compile time
        # (CBO dominates), but compile-latency-critical embedders can turn
        # them off — traces then carry timings/hits only
        self.capture_diffs = capture_diffs
        if verify not in VERIFY_MODES:
            raise PipelineError(f"unknown verify mode {verify!r}; "
                                f"modes are {VERIFY_MODES}")
        self.verify = verify
        self._verified: collections.OrderedDict = collections.OrderedDict()
        for p in passes:
            self.register(p)

    # ---------------------------------------------------------- registration
    def register(self, p: Pass, *, before: str | None = None,
                 after: str | None = None) -> "OptimizerPipeline":
        if p.phase not in PHASES:
            raise PipelineError(
                f"pass {p.name!r} declares unknown phase {p.phase!r}; "
                f"phases are {PHASES}")
        if any(q.name == p.name for q in self._passes):
            raise PipelineError(f"pass {p.name!r} is already registered")
        if before is not None and after is not None:
            raise PipelineError("give at most one of before=/after=")
        anchor = before or after
        if anchor is not None:
            idx = next((i for i, q in enumerate(self._passes)
                        if q.name == anchor), None)
            if idx is None:
                raise PipelineError(f"no registered pass named {anchor!r}")
            if self._passes[idx].phase != p.phase:
                raise PipelineError(
                    f"{anchor!r} is in phase {self._passes[idx].phase!r}, "
                    f"cannot anchor a {p.phase!r} pass on it")
            self._passes.insert(idx if before else idx + 1, p)
        else:
            # append at the end of this pass's phase block
            order = {ph: i for i, ph in enumerate(PHASES)}
            idx = len(self._passes)
            for i, q in enumerate(self._passes):
                if order[q.phase] > order[p.phase]:
                    idx = i
                    break
            self._passes.insert(idx, p)
        return self

    def register_rule(self, rule: Rule) -> "OptimizerPipeline":
        """Sugar: wrap a heuristic ``Rule`` as an rbo-phase pass."""
        return self.register(RulePass(rule))

    def remove(self, name: str) -> Pass:
        for i, p in enumerate(self._passes):
            if p.name == name:
                return self._passes.pop(i)
        raise PipelineError(f"no registered pass named {name!r}")

    def passes(self, phase: str | None = None) -> list[Pass]:
        if phase is None:
            return list(self._passes)
        return [p for p in self._passes if p.phase == phase]

    def signature(self) -> tuple[str, ...]:
        """Stable identity of the registered sequence — part of the
        prepared-plan cache key, so registering a pass never serves plans
        compiled by a differently-shaped pipeline."""
        return tuple(f"{p.phase}:{p.name}" for p in self._passes)

    # ----------------------------------------------------------------- drive
    def run(self, ctx: PassContext) -> PipelineTrace:
        t0 = time.perf_counter()
        mode = ctx.flags.get("verify") or self.verify
        if mode not in VERIFY_MODES:
            raise PipelineError(f"unknown verify mode {mode!r}; "
                                f"modes are {VERIFY_MODES}")
        # expect_sat flips once the type_inference pass has *proven* the
        # pattern satisfiable: from then on, a pass whose output is
        # unsatisfiable broke a valid plan (violation) rather than
        # discovered an empty result (clean verified-empty short-circuit)
        state = {"expect_sat": False}
        check = self._make_checker(ctx, state) if mode == "always" else None
        traces: list[PassTrace] = []
        for phase in PHASES:
            group = [p for p in self._passes if p.phase == phase]
            if group:
                if phase == "rbo":
                    traces.extend(self._run_fixpoint(group, ctx, check))
                else:
                    for p in group:
                        traces.append(self._run_one(p, ctx, check))
                        if ctx.invalid:
                            break
            if (phase == "type_inference" and not ctx.invalid
                    and any(t.name == "type_inference" and not t.skipped
                            for t in traces)):
                state["expect_sat"] = True
            if ctx.invalid:
                break
        report = self._verify_final(ctx, state) if mode != "off" else None
        return PipelineTrace(traces, wall_s=time.perf_counter() - t0,
                             invalid=ctx.invalid, verify=report)

    # ---------------------------------------------------------- verification
    def _verifier(self, ctx: PassContext) -> PlanVerifier:
        return PlanVerifier(ctx.schema, spec=ctx.spec,
                            store=getattr(ctx.stats, "store", None))

    def _make_checker(self, ctx: PassContext, state: dict):
        verifier = self._verifier(ctx)

        def check(p: Pass, tr: PassTrace) -> None:
            report = verifier.verify(ctx.plan, ctx.physical,
                                     invalid=ctx.invalid,
                                     expect_satisfiable=state["expect_sat"])
            if not report.ok:
                raise PlanInvariantError(report.violations, pass_name=p.name,
                                         phase=p.phase, trace=tr)
        return check

    def _verify_final(self, ctx: PassContext, state: dict) -> VerifyReport:
        key = (ir.canonical_form(ctx.plan), ctx.spec.name,
               plan_signature(ctx.physical) if ctx.physical is not None
               else None, ctx.invalid)
        hit = self._verified.get(key)
        if hit is not None:
            self._verified.move_to_end(key)
            return dataclasses.replace(hit, cached=True)
        report = self._verifier(ctx).verify(
            ctx.plan, ctx.physical, invalid=ctx.invalid,
            expect_satisfiable=state["expect_sat"])
        if not report.ok:
            # no offending pass to name: the defect was only detected on
            # the final output (use verify="always" to bisect)
            raise PlanInvariantError(report.violations)
        self._verified[key] = report
        if len(self._verified) > self.VERIFY_MEMO_SIZE:
            self._verified.popitem(last=False)
        return report

    def _run_one(self, p: Pass, ctx: PassContext, check=None) -> PassTrace:
        reason = p.skip(ctx)
        if reason is not None:
            return PassTrace(p.name, p.phase, skipped=reason)
        before = _snapshot(ctx) if self.capture_diffs else []
        t0 = time.perf_counter()
        changed = bool(p.run(ctx))
        dt = time.perf_counter() - t0
        after = (_snapshot(ctx) if changed and self.capture_diffs
                 else before)
        tr = PassTrace(p.name, p.phase, wall_s=dt, changed=changed,
                       hits=int(changed), diff=_diff(before, after))
        if check is not None:
            check(p, tr)
        return tr

    def _run_fixpoint(self, group: list[Pass], ctx: PassContext,
                      check=None) -> list[PassTrace]:
        """HepPlanner-style driver: apply every eligible rbo pass repeatedly
        until none reports a change (or MAX_RBO_ITERS)."""
        traces = {p.name: PassTrace(p.name, p.phase) for p in group}
        eligible = []
        for p in group:
            reason = p.skip(ctx)
            if reason is not None:
                traces[p.name].skipped = reason
            else:
                eligible.append(p)
        if eligible:
            ctx.counters["rbo"] += 1
        for _ in range(self.MAX_RBO_ITERS):
            any_changed = False
            for p in eligible:
                tr = traces[p.name]
                before = _snapshot(ctx) if self.capture_diffs else []
                t0 = time.perf_counter()
                changed = bool(p.run(ctx))
                tr.wall_s += time.perf_counter() - t0
                if changed:
                    tr.changed = True
                    tr.hits += 1
                    if self.capture_diffs:
                        tr.diff.extend(_diff(before, _snapshot(ctx)))
                if check is not None:
                    check(p, tr)
                any_changed |= changed
                if ctx.invalid:     # short-circuit, like the phase driver
                    return [traces[p.name] for p in group]
            if not any_changed:
                break
        return [traces[p.name] for p in group]


# --------------------------------------------------------------------------
# Built-in passes (the old GOpt.optimize if-ladder, as registrable pieces)
# --------------------------------------------------------------------------


class ExpandPathsPass(Pass):
    """Unfold hops>1 EXPAND_PATH edges into 1-hop chains (§4.1)."""

    name = "expand_paths"
    phase = "pre"

    def run(self, ctx: PassContext) -> bool:
        pattern = ctx.pattern()
        had_paths = any(e.hops > 1 for e in pattern.edges)
        ctx.plan.replace_pattern(expand_path_edges(pattern, ctx.schema))
        return had_paths


class TypeInferencePass(Pass):
    """Algorithm 1; flags ``invalid`` when the pattern is unsatisfiable."""

    name = "type_inference"
    phase = "type_inference"

    def skip(self, ctx):
        if not ctx.flags.get("type_inference", True):
            return "disabled (type_inference=False)"
        return None

    def run(self, ctx: PassContext) -> bool:
        ctx.counters["type_inference"] += 1
        pattern = ctx.pattern()
        inferred = infer_types(pattern, ctx.schema)
        if inferred == INVALID:
            ctx.invalid = True
            return True
        changed = inferred.canonical_key() != pattern.canonical_key()
        ctx.plan.replace_pattern(inferred)
        return changed


class RulePass(Pass):
    """Adapter: any heuristic ``rules.Rule`` as an rbo fixpoint-group pass."""

    phase = "rbo"

    def __init__(self, rule: Rule):
        self.rule = rule
        self.name = rule.name

    def skip(self, ctx):
        if not ctx.flags.get("rbo", True):
            return "disabled (rbo=False)"
        return None

    def run(self, ctx: PassContext) -> bool:
        return self.rule.apply(ctx.plan)


class CboPass(Pass):
    """Algorithm 2 (or the left-deep fallback) over the optimized pattern.

    Publishes ``ctx.estimator`` and always annotates the chosen plan with
    per-operator frequency/cost estimates so EXPLAIN has numbers even for
    non-CBO plans."""

    name = "cbo"
    phase = "cbo"

    def run(self, ctx: PassContext) -> bool:
        pattern = ctx.pattern()
        est = CardEstimator(
            ctx.stats,
            ctx.glogue if ctx.flags.get("use_glogue", True) else None,
            use_selectivity=ctx.flags.get("use_selectivity", True),
            params=ctx.plan.params)
        ctx.estimator = est
        if ctx.flags.get("cbo", True) and pattern.is_connected():
            ctx.counters["cbo"] += 1
            ctx.physical = GraphOptimizer(est, spec=ctx.spec).optimize(pattern)
        else:
            # disconnected patterns: cross-product plan (Algorithm 2
            # searches connected sub-patterns only)
            ctx.physical = default_left_deep_plan(pattern)
        annotate_estimates(ctx.physical, pattern, est, ctx.spec.cost)
        return True


class PhysicalRulesPass(Pass):
    """Backend seam: apply the active spec's registered post-CBO physical
    rewrites (``PhysicalSpec.physical_rules``) to the physical plan."""

    name = "physical_rules"
    phase = "post_physical"

    def skip(self, ctx):
        if not ctx.flags.get("physical_rules", True):
            return "disabled (physical_rules=False)"
        if not ctx.spec.physical_rules:
            return f"no physical rules registered by {ctx.spec.name!r}"
        return None

    def run(self, ctx: PassContext) -> bool:
        if ctx.physical is None:
            return False
        changed = False
        for rule in ctx.spec.physical_rules:
            out = rule(ctx.physical, ctx)
            if out is not None and out is not ctx.physical:
                ctx.physical = out
                changed = True
        return changed


class IntersectToJoinPass(Pass):
    """Registrable post-CBO decomposition of expand-and-intersect into a
    binary join (DESIGN.md §6.2): a multi-edge ``ExpandNode`` — expand
    along its first edge, WCOJ-probe the rest — rewrites to
    ``Join(Expand(child, e1), Expand(Scan(other(e_i)), e_i))`` on the
    extra edges, joining on the shared ``(other_endpoint, new_alias)``
    keys.  Until now this alternative existed only inside Algorithm 2's
    search (steered by ``alpha_intersect`` vs ``alpha_join``); registering
    this pass applies it to *any* physical plan, including the left-deep
    fallback and ablation plans the CBO never searched.

    ``force=True`` decomposes every multi-edge expand; the default
    consults the backend's ``CostParams`` (including the distributed
    backends' ``alpha_exchange`` term) and rewrites only where the join
    side estimates cheaper.  Register it *before* ``physical_rules`` on
    fusing backends — chain fusion may otherwise swallow the multi-edge
    expand into a fused WCOJ tail first."""

    name = "intersect_to_join"
    phase = "post_physical"

    def __init__(self, force: bool = False):
        self.force = force

    def skip(self, ctx):
        if ctx.physical is None:
            return "no physical plan"
        return None

    def run(self, ctx: PassContext) -> bool:
        pattern = ctx.pattern()
        est, cost = ctx.estimator, ctx.spec.cost
        changed = False

        def decompose(n):
            nonlocal changed
            e1, rest = n.edges[0], n.edges[1:]
            f_left = (est.pattern_freq(
                pattern, n.child.bound_aliases() | {n.new_alias})
                if est is not None else n.est_frequency)
            node = ExpandNode(n.child, n.new_alias, [e1],
                              est_frequency=f_left,
                              est_cost=n.child.est_cost + f_left)
            for e in rest:
                b = e.other(n.new_alias)
                fb = est.vertex_freq(pattern, b) if est is not None else 0.0
                scan = ScanNode(b, est_frequency=fb,
                                est_cost=cost.alpha_scan * fb)
                fr = (fb * est.expand_sigma(pattern, e, n.new_alias)
                      if est is not None else 0.0)
                right = ExpandNode(scan, n.new_alias, [e],
                                   est_frequency=fr,
                                   est_cost=scan.est_cost + fr)
                keys = tuple(sorted({b, n.new_alias}))
                node = JoinNode(node, right, keys,
                                est_frequency=n.est_frequency,
                                est_cost=(node.est_cost + right.est_cost
                                          + n.est_frequency
                                          + (cost.alpha_join
                                             + cost.alpha_exchange)
                                          * (node.est_frequency + fr)))
            changed = True
            return node

        def join_cheaper(n) -> bool:
            if self.force:
                return True
            if est is None:
                return False
            f_src = n.child.est_frequency
            probe = f_src * sum(
                cost.alpha_intersect * est.expand_sigma(pattern, e, None)
                for e in n.edges[1:])
            join_c = 0.0
            for e in n.edges[1:]:
                b = e.other(n.new_alias)
                fb = est.vertex_freq(pattern, b)
                fr = fb * est.expand_sigma(pattern, e, n.new_alias)
                join_c += (cost.alpha_scan * fb + fr
                           + (cost.alpha_join + cost.alpha_exchange)
                           * (f_src + fr))
            return join_c < probe

        def rec(n):
            if isinstance(n, ExpandNode):
                n.child = rec(n.child)
                if len(n.edges) > 1 and join_cheaper(n):
                    return decompose(n)
            elif isinstance(n, JoinNode):
                n.left, n.right = rec(n.left), rec(n.right)
            elif isinstance(n, ExpandChainNode):
                # fused chains are a backend rewrite downstream of this
                # one; their WCOJ tails stay fused
                n.child = rec(n.child)
            return n

        ctx.physical = rec(ctx.physical)
        return changed


def default_pipeline() -> OptimizerPipeline:
    """The standard pass sequence: path unfolding, type inference, the
    heuristic-rule fixpoint group (paper rules + the extended registrable
    rules), CBO, then backend physical rewrites."""
    pl = OptimizerPipeline()
    pl.register(ExpandPathsPass())
    pl.register(TypeInferencePass())
    for r in DEFAULT_RULES:
        pl.register_rule(r)
    for r in EXTENDED_RULES:
        pl.register_rule(r)
    pl.register(CboPass())
    pl.register(PhysicalRulesPass())
    return pl


# --------------------------------------------------------------------------
# EXPLAIN / PROFILE
# --------------------------------------------------------------------------

# engine ExecStats.op_rows entries that correspond 1:1 (in post-order) with
# the physical pattern-plan operators; GET_VERTEX lines are the unfused
# ablation's extra pass and belong to their EXPAND
_PATTERN_LOG_PREFIXES = ("SCAN(", "EXPAND(", "EXPANDCHAIN(", "JOIN(")


@dataclasses.dataclass
class OpReport:
    """One physical operator's estimated-vs-actual numbers."""
    op: str
    depth: int
    est_rows: float
    est_cost: float
    actual_rows: int | None = None
    # measured wall time under analyze=True (dispatch time on async
    # backends; the final device sync is absorbed by delivery)
    actual_time_s: float | None = None


@dataclasses.dataclass
class ExplainReport:
    """Structured EXPLAIN/PROFILE output (DESIGN.md §6.3).

    ``operators`` lists the physical pattern operators in tree order (root
    first, children indented by ``depth``); ``tail`` holds the relational
    operators' actual ``(name, rows, wall_s)`` under ``analyze=True``.
    ``invalid`` marks a query type inference proved unsatisfiable — no
    physical plan exists and execution returns zero rows."""
    source: str | None
    backend: str
    analyze: bool
    invalid: bool
    compile_s: float
    trace: PipelineTrace | None
    physical: PlanNode | None
    operators: list[OpReport]
    tail: list[tuple[str, int, float]]
    result_rows: int | None = None
    exec_wall_s: float | None = None
    # PROFILE SYNC mode: the engine blocked on the device after every
    # operator, so actual_time_s are true device times, not dispatch times
    sync: bool = False
    # serving-ledger section (QueryServer.explain attaches the plan's
    # ServeStats summary dict here): wave sizes/occupancy, queue delay vs
    # execution time, fallback counts — rendered as "-- serve --"
    serve: dict | None = None
    # device-to-device collective summary from ExecStats.exchanges
    # ({"kind:label": {"calls": n, "elems": m}}), PROFILE on the sharded
    # backend only — rendered as "-- exchanges --"
    exchanges: dict | None = None
    # delta-overlay ledger (``MutableGraphStore.delta_info()``): overlay
    # occupancy, snapshot spread, compaction events — rendered as
    # "-- delta --" when the store is mutable
    delta: dict | None = None

    def render(self, diffs: bool = False) -> str:
        head = ("PROFILE SYNC" if self.analyze and self.sync
                else "PROFILE" if self.analyze else "EXPLAIN")
        lines = [f"{head} (backend={self.backend}, "
                 f"compile={self.compile_s * 1e3:.2f}ms)"]
        if self.source:
            lines.append(f"query: {self.source}")
        if self.trace is not None:
            lines.append("-- pipeline --")
            lines.extend("  " + l for l in self.trace.render_lines(diffs))
        vr = self.verify
        if vr is not None:
            lines.append("-- verify --")
            lines.append(f"  status={vr['status']} checks={vr['checks']} "
                         f"wall={vr['wall_ms']:.3f}ms"
                         + (" (cached)" if vr["cached"] else ""))
            lines.extend(f"  violation: {v}" for v in vr["violations"])
        if self.invalid:
            lines.append(UNSAT_MESSAGE)
        else:
            lines.append("-- physical plan --")
            for op in self.operators:
                act = (f" act={op.actual_rows}"
                       if op.actual_rows is not None else "")
                if op.actual_time_s is not None:
                    act += f" time={op.actual_time_s * 1e3:.2f}ms"
                lines.append(f"  {'  ' * op.depth}{op.op} "
                             f"[est={op.est_rows:.3g} "
                             f"cost={op.est_cost:.3g}{act}]")
            if self.tail:
                lines.append("-- relational tail --")
                lines.extend(f"  {name} rows={rows} "
                             f"time={secs * 1e3:.2f}ms"
                             for name, rows, secs in self.tail)
        if self.exchanges:
            lines.append("-- exchanges --")
            lines.extend(f"  {k}: calls={v['calls']} elems={v['elems']}"
                         for k, v in self.exchanges.items())
        if self.serve:
            lines.append("-- serve --")
            lines.extend(f"  {k}: {v}" for k, v in self.serve.items())
        if self.delta:
            lines.append("-- delta --")
            lines.extend(f"  {k}: {v}" for k, v in self.delta.items())
        if self.result_rows is not None:
            wall = (f" in {self.exec_wall_s * 1e3:.2f}ms"
                    if self.exec_wall_s is not None else "")
            lines.append(f"result: {self.result_rows} rows{wall}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    # convenience accessors used by tests / tooling
    @property
    def verify(self) -> dict | None:
        """``VerifyReport.summary()`` of the pipeline's static verification
        (None when ``verify="off"`` or the report predates verification)."""
        rep = getattr(self.trace, "verify", None) if self.trace else None
        return rep.summary() if rep is not None else None

    def pass_names(self) -> list[str]:
        return [t.name for t in self.trace.passes] if self.trace else []

    def estimated_vs_actual(self) -> list[tuple[str, float, int | None]]:
        return [(o.op, o.est_rows, o.actual_rows) for o in self.operators]


def _tree_order(node: PlanNode) -> list[tuple[PlanNode, int]]:
    """Root-first render order with depths (children below their parent)."""
    out: list[tuple[PlanNode, int]] = []

    def rec(n: PlanNode, depth: int):
        out.append((n, depth))
        for c in plan_children(n):
            rec(c, depth + 1)

    rec(node, 0)
    return out


def build_explain_report(opt, spec: PhysicalSpec, source: str | None = None,
                         analyze: bool = False, table=None,
                         stats=None, sync: bool = False,
                         delta: dict | None = None) -> ExplainReport:
    """Assemble an ``ExplainReport`` from an ``OptimizedQuery`` (and, under
    ``analyze=True``, the execution's result table + ``ExecStats``).

    Handles the type-inference-INVALID case (``opt.physical is None``)
    by reporting the provably-empty result instead of crashing."""
    trace = getattr(opt, "trace", None)
    if opt.invalid or opt.physical is None:
        return ExplainReport(
            source=source, backend=spec.name, analyze=analyze, invalid=True,
            compile_s=opt.compile_s, trace=trace, physical=None,
            operators=[], tail=[],
            result_rows=0 if analyze else None,
            exec_wall_s=stats.wall_s if stats is not None else None,
            sync=sync, delta=delta)

    post = plan_operators(opt.physical)          # execution (post-)order
    actual_by_node: dict[int, int] = {}
    time_by_node: dict[int, float] = {}
    tail: list[tuple[str, int, float]] = []
    if stats is not None:
        # op_times entries are logged 1:1 with op_rows (same call); zip them
        # back together, defensively zero-filling foreign ExecStats
        times = (stats.op_times if len(getattr(stats, "op_times", ()))
                 == len(stats.op_rows)
                 else [(n, 0.0) for n, _ in stats.op_rows])
        logs = [(name, r, secs) for (name, r), (_, secs)
                in zip(stats.op_rows, times)]
        pat_logs = [l for l in logs
                    if l[0].startswith(_PATTERN_LOG_PREFIXES)]
        i = 0
        for n in post:
            if i >= len(pat_logs):
                break
            name, rows, secs = pat_logs[i]
            if (isinstance(n, ExpandChainNode)
                    and not name.startswith("EXPANDCHAIN(")):
                # the fuse_expand=False ablation executed the unfused plan:
                # one EXPAND log line per hop — the chain's output is the
                # last hop's, its time the hops' sum
                last = min(i + len(n.steps), len(pat_logs))
                rows = pat_logs[last - 1][1]
                secs = sum(l[2] for l in pat_logs[i:last])
                i = last
            else:
                i += 1
            actual_by_node[id(n)] = rows
            time_by_node[id(n)] = secs
        tail = [l for l in logs
                if not l[0].startswith(_PATTERN_LOG_PREFIXES)
                and not l[0].startswith("GET_VERTEX")]
    operators = [
        OpReport(describe_node(n), depth, n.est_frequency, n.est_cost,
                 actual_by_node.get(id(n)), time_by_node.get(id(n)))
        for n, depth in _tree_order(opt.physical)]
    return ExplainReport(
        source=source, backend=spec.name, analyze=analyze, invalid=False,
        compile_s=opt.compile_s, trace=trace, physical=opt.physical,
        operators=operators, tail=tail,
        result_rows=table.nrows if table is not None else None,
        exec_wall_s=stats.wall_s if stats is not None else None,
        sync=sync,
        exchanges=getattr(stats, "exchanges", None)
        if stats is not None else None,
        delta=delta)
