"""PlanVerifier — static invariant checking for GIR and physical plans
(DESIGN.md §12).

The optimizer is deliberately open: ``OptimizerPipeline`` accepts registered
third-party passes/rules and ``PhysicalSpec`` third-party operator sets —
but an invalid rewrite used to surface only as wrong rows (or a crash) deep
inside the engine.  ``PlanVerifier`` proves, *statically*, that a plan is
still well-formed:

- **plan shape** — a single leading MATCH_PATTERN, edges anchored on
  declared pattern vertices, no alias collisions, hops >= 1;
- **alias scope** — def-before-use and liveness of every alias/column
  reference through the relational tail, mirroring the engine's binding
  table semantics (``Var`` needs an id column, ``Prop`` resolves for vertex
  aliases and for edge aliases via their ``#t``/``#p`` identity columns,
  PROJECT/GROUP replace the column set, ORDER BY may name aggregate
  outputs by their serialized form);
- **parameter discipline** — no expression references a *structural*
  parameter that was baked into the pattern shape at build time;
- **satisfiability & schema soundness** — runs type inference (Algorithm
  1): an unsatisfiable pattern short-circuits to a clean ``verified-empty``
  report (the engine returns zero rows; that is a *result*, not an
  invariant violation) unless the caller asserts the plan was satisfiable
  before the pass under test ran; on the inferred pattern, every edge's
  triples must be schema triples consistent with its endpoints' type sets
  and every property access must exist on the alias's inferred types;
- **physical cover** — the physical plan binds exactly the pattern's
  vertices, traverses exactly its edges, expands each new alias along
  pattern edges into already-bound endpoints, joins on bound keys, and
  scopes every bind-time predicate over aliases bound at that point;
- **chain contracts** — ``ExpandChainNode`` hop continuity (each
  ``from_alias`` bound by the child or an earlier step), endpoint
  agreement, def-once hops, WCOJ ``intersect_edges`` only on the *last*
  step and only into bound aliases, and bound-at-step predicate scoping;
- **delta/epoch consistency** — a chain's memoized ``ChainSpec`` for this
  store must have been compiled at the store's current compaction epoch;
- **capacity monotonicity** — every live fused-chain program's capacity
  schedule is power-of-two buckets and no cached program exceeds the
  handle's current caps (caps only grow, element-wise);
- **operator dtype contracts** — the active backend's built operator set
  honors the bool-mask / integer-column dtype contract
  (``physical_spec.dtype_contract_failures``, checked once per operator
  set).

``verify`` returns a ``VerifyReport``; the pipeline wiring
(``OptimizerPipeline(verify="off"|"cached"|"always")``) raises
``PlanInvariantError`` naming the offending pass when a report carries
violations.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core import ir
from repro_torch.core.pattern import Pattern
from repro_torch.core.physical import (ExpandChainNode, ExpandNode, JoinNode,
                                 PlanNode, ScanNode)
from repro_torch.core.schema import GraphSchema
from repro_torch.core.type_inference import (INVALID, _edge_triples_consistent,
                                       infer_types)

OK = "ok"
VERIFIED_EMPTY = "verified-empty"
INVALID_PLAN = "invalid"


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one ``PlanVerifier.verify`` run.

    ``status`` is ``"ok"``, ``"verified-empty"`` (type inference proved the
    pattern unsatisfiable — zero rows, by proof, with the structural checks
    still clean) or ``"invalid"``; ``checks`` names the check groups that
    ran; ``cached`` marks a report served from the pipeline's per-canonical-
    form memo rather than re-verified."""
    status: str
    checks: tuple[str, ...] = ()
    violations: tuple[str, ...] = ()
    wall_s: float = 0.0
    cached: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> dict:
        return {"status": self.status, "checks": len(self.checks),
                "violations": list(self.violations),
                "wall_ms": round(self.wall_s * 1e3, 3),
                "cached": self.cached}


class PlanVerifier:
    """Static checker for one (schema, backend spec, store) context.

    ``spec``/``store`` are optional: without them the physical-contract
    checks that need a built operator set (capacity monotonicity, dtype
    contracts) and the delta-epoch check are skipped — the plan-level
    checks never need a store."""

    def __init__(self, schema: GraphSchema, spec=None, store=None):
        self.schema = schema
        self.spec = spec
        self.store = store

    # ------------------------------------------------------------------ drive
    def verify(self, plan: ir.LogicalPlan, physical: PlanNode | None = None,
               *, invalid: bool = False,
               expect_satisfiable: bool = False) -> VerifyReport:
        t0 = time.perf_counter()
        v: list[str] = []
        checks: list[str] = []
        pattern = plan.pattern()

        checks.append("plan-shape")
        self._check_shape(plan, pattern, v)
        if pattern is None or v:
            # no pattern (or a malformed one): the scoped walks below would
            # only cascade noise off the same defect
            return self._report(v, checks, t0, unsat=invalid and not v)

        checks.append("alias-scope")
        self._check_alias_scope(plan, pattern, v)
        checks.append("param-bindings")
        self._check_params(plan, v)

        checks.append("satisfiability")
        if invalid:
            # the pipeline already proved unsatisfiability; structural
            # checks above still apply, schema/physical checks need the
            # inferred types that do not exist
            return self._report(v, checks, t0, unsat=True)
        inferred = infer_types(pattern, self.schema)
        if inferred == INVALID:
            if expect_satisfiable:
                v.append("satisfiability: pass turned a satisfiable "
                         "pattern unsatisfiable (type inference now "
                         "proves zero rows)")
                return self._report(v, checks, t0)
            return self._report(v, checks, t0, unsat=True)

        checks.append("schema-edges")
        self._check_schema_edges(inferred, v)
        checks.append("schema-props")
        self._check_schema_props(plan, pattern, inferred, v)

        if physical is not None:
            checks.append("physical-cover")
            checks.append("chain-contract")
            self._check_physical(pattern, physical, v)
            checks.append("delta-epoch")
            self._check_delta_epochs(physical, v)
            checks.append("capacity-pow2")
            self._check_capacities(v)
            checks.append("operator-contracts")
            self._check_operator_contracts(v)
        return self._report(v, checks, t0)

    def _report(self, v, checks, t0, unsat: bool = False) -> VerifyReport:
        status = (INVALID_PLAN if v else
                  VERIFIED_EMPTY if unsat else OK)
        return VerifyReport(status, tuple(checks), tuple(v),
                            wall_s=time.perf_counter() - t0)

    # ------------------------------------------------------------- plan shape
    def _check_shape(self, plan, pattern, v: list[str]) -> None:
        if not plan.ops:
            v.append("plan-shape: plan has no operators")
            return
        matches = [i for i, op in enumerate(plan.ops)
                   if isinstance(op, ir.MatchPattern)]
        if not matches:
            v.append("plan-shape: plan has no MATCH_PATTERN")
            return
        if matches != [0]:
            v.append(f"plan-shape: MATCH_PATTERN must be the single leading "
                     f"operator (found at positions {matches})")
        if pattern is None or not pattern.vertices:
            v.append("plan-shape: pattern has no vertices")
            return
        seen_edges: set[str] = set()
        for e in pattern.edges:
            for end in (e.src, e.dst):
                if end not in pattern.vertices:
                    v.append(f"plan-shape: edge {e.alias!r} endpoint "
                             f"{end!r} is not a pattern vertex")
            if e.alias in pattern.vertices:
                v.append(f"plan-shape: edge alias {e.alias!r} collides "
                         f"with a vertex alias")
            if e.alias in seen_edges:
                v.append(f"plan-shape: duplicate edge alias {e.alias!r}")
            seen_edges.add(e.alias)
            if e.hops < 1:
                v.append(f"plan-shape: edge {e.alias!r} has hops={e.hops}")

    # ------------------------------------------------------------ alias scope
    def _check_alias_scope(self, plan, pattern: Pattern,
                           v: list[str]) -> None:
        vertex_aliases = set(pattern.vertices)
        edge_aliases = {e.alias for e in pattern.edges}
        known = vertex_aliases | edge_aliases

        for pv in pattern.vertices.values():
            for p in pv.predicates:
                bad = ir.expr_aliases(p) - known
                if bad:
                    v.append(f"alias-scope: predicate on vertex "
                             f"{pv.alias!r} references unknown alias(es) "
                             f"{sorted(bad)}: {p!r}")
        for pe in pattern.edges:
            for p in pe.predicates:
                bad = ir.expr_aliases(p) - known
                if bad:
                    v.append(f"alias-scope: predicate on edge "
                             f"{pe.alias!r} references unknown alias(es) "
                             f"{sorted(bad)}: {p!r}")

        # walk the relational tail with the engine's column semantics:
        # var_cols = names usable as a bare Var (id / output columns),
        # prop_ok  = names usable as a Prop base (vertex id columns and,
        # before any PROJECT/GROUP, edge aliases via their #t/#p columns)
        var_cols = set(vertex_aliases)
        prop_ok = set(vertex_aliases) | edge_aliases

        def scoped(e, where: str) -> None:
            bad_var = ir.expr_var_aliases(e) - var_cols
            if bad_var:
                v.append(f"alias-scope: {where} references unbound "
                         f"column(s) {sorted(bad_var)}: {e!r}")
            bad_prop = {p.alias for p in ir.expr_props(e)} - prop_ok
            if bad_prop:
                v.append(f"alias-scope: {where} dereferences propert"
                         f"{'ies' if len(bad_prop) > 1 else 'y'} of "
                         f"dropped alias(es) {sorted(bad_prop)}: {e!r}")

        for op in plan.ops[1:]:
            if isinstance(op, ir.Select):
                scoped(op.predicate, "SELECT")
            elif isinstance(op, ir.Project):
                for e, name in op.items:
                    scoped(e, f"PROJECT item {name!r}")
                var_cols = {name for _, name in op.items}
                prop_ok = {name for e, name in op.items
                           if isinstance(e, ir.Var) and e.alias in prop_ok}
            elif isinstance(op, ir.GroupBy):
                for e, name in op.keys:
                    scoped(e, f"GROUP key {name!r}")
                for a, name in op.aggs:
                    scoped(a, f"GROUP aggregate {name!r}")
                new_vars = ({name for _, name in op.keys}
                            | {name for _, name in op.aggs})
                prop_ok = {name for e, name in op.keys
                           if isinstance(e, ir.Var) and e.alias in prop_ok}
                var_cols = new_vars
            elif isinstance(op, ir.OrderBy):
                for e, _asc in op.items:
                    if isinstance(e, ir.Var) and e.alias in var_cols:
                        continue
                    if repr(e) in var_cols:   # aggregate-output trick
                        continue
                    scoped(e, "ORDER BY")
            elif isinstance(op, (ir.Limit, ir.MatchPattern)):
                pass

    # ------------------------------------------------------------- parameters
    def _check_params(self, plan, v: list[str]) -> None:
        structural = set(plan.hints.get("structural_params") or {})
        rebound = plan.referenced_params() & structural
        if rebound:
            v.append(f"param-bindings: structural parameter(s) "
                     f"{sorted('$' + p for p in rebound)} were baked into "
                     f"the pattern at build time but are referenced by a "
                     f"plan expression — a rewrite re-introduced a consumed "
                     f"parameter")

    # ------------------------------------------------------ schema soundness
    def _check_schema_edges(self, inferred: Pattern, v: list[str]) -> None:
        legal = self.schema.all_edge_triples()
        for e in inferred.edges:
            rogue = e.triples - legal
            if rogue:
                v.append(f"schema-edges: edge {e.alias!r} carries triple(s) "
                         f"not in the schema: {sorted(map(repr, rogue))}")
            ok = _edge_triples_consistent(
                e, inferred.vertices[e.src].types,
                inferred.vertices[e.dst].types)
            if not ok:
                v.append(f"schema-edges: edge {e.alias!r} "
                         f"({e.src!r}-{sorted(e.labels())}->{e.dst!r}) has "
                         f"no triple consistent with its endpoints' "
                         f"inferred types")

    def _iter_plan_props(self, plan, pattern: Pattern):
        for pv in pattern.vertices.values():
            for p in pv.predicates:
                yield from ir.expr_props(p)
        for pe in pattern.edges:
            for p in pe.predicates:
                yield from ir.expr_props(p)
        for op in plan.ops[1:]:
            if isinstance(op, ir.Select):
                yield from ir.expr_props(op.predicate)
            elif isinstance(op, ir.Project):
                for e, _ in op.items:
                    yield from ir.expr_props(e)
            elif isinstance(op, ir.GroupBy):
                for e, _ in op.keys:
                    yield from ir.expr_props(e)
                for a, _ in op.aggs:
                    yield from ir.expr_props(a)
            elif isinstance(op, ir.OrderBy):
                for e, _ in op.items:
                    yield from ir.expr_props(e)

    def _check_schema_props(self, plan, pattern: Pattern, inferred: Pattern,
                            v: list[str]) -> None:
        edge_labels = {e.alias: e.labels() for e in inferred.edges}
        seen: set[ir.Prop] = set()
        for p in self._iter_plan_props(plan, pattern):
            if p in seen:
                continue
            seen.add(p)
            if p.alias in inferred.vertices:
                types = inferred.vertices[p.alias].types
                names = set()
                for t in types:
                    names |= set(self.schema.vertex_props.get(t, {}))
                if p.name not in names:
                    v.append(f"schema-props: {p!r} — no vertex type in "
                             f"{sorted(types)} declares property "
                             f"{p.name!r}")
            elif p.alias in edge_labels:
                names = set()
                for lb in edge_labels[p.alias]:
                    names |= set(self.schema.edge_props.get(lb, {}))
                if p.name not in names:
                    v.append(f"schema-props: {p!r} — no edge label in "
                             f"{sorted(edge_labels[p.alias])} declares "
                             f"property {p.name!r}")
            # aliases minted by PROJECT/GROUP outputs are column names,
            # not schema elements; the alias-scope walk owns those

    # ---------------------------------------------------------- physical plan
    def _check_physical(self, pattern: Pattern, physical: PlanNode,
                        v: list[str]) -> None:
        pat_edges = {e.alias: e for e in pattern.edges}

        def check_edge(e, new_alias: str, bound: set[str],
                       where: str) -> None:
            pe = pat_edges.get(e.alias)
            if pe is None:
                v.append(f"physical-cover: {where} traverses edge "
                         f"{e.alias!r} that is not in the pattern")
                return
            if {e.src, e.dst} != {pe.src, pe.dst}:
                v.append(f"physical-cover: {where} edge {e.alias!r} "
                         f"endpoints ({e.src!r},{e.dst!r}) disagree with "
                         f"the pattern's ({pe.src!r},{pe.dst!r})")
            if new_alias not in (e.src, e.dst):
                v.append(f"physical-cover: {where} edge {e.alias!r} does "
                         f"not touch the alias {new_alias!r} it binds")
                return
            other = e.other(new_alias)
            if other not in bound:
                v.append(f"physical-cover: {where} edge {e.alias!r} "
                         f"anchors on {other!r} which is not bound yet")

        def check_preds(preds, scope: set[str], where: str) -> None:
            for p in preds or ():
                bad = ir.expr_aliases(p) - scope
                if bad:
                    v.append(f"physical-cover: {where} predicate {p!r} "
                             f"references alias(es) {sorted(bad)} not "
                             f"bound at that point")

        def vertex_preds(alias: str):
            pv = pattern.vertices.get(alias)
            return pv.predicates if pv is not None else ()

        def walk(node) -> tuple[set[str], set[str]]:
            """Returns (bound vertex aliases, traversed edge aliases)."""
            if isinstance(node, ScanNode):
                if node.alias not in pattern.vertices:
                    v.append(f"physical-cover: Scan({node.alias!r}) is not "
                             f"a pattern vertex")
                    return {node.alias}, set()
                check_preds(vertex_preds(node.alias), {node.alias},
                            f"Scan({node.alias})")
                return {node.alias}, set()
            if isinstance(node, ExpandNode):
                bound, used = walk(node.child)
                where = f"Expand(+{node.new_alias})"
                if node.new_alias in bound:
                    v.append(f"physical-cover: {where} re-binds an "
                             f"already-bound alias")
                if node.new_alias not in pattern.vertices:
                    v.append(f"physical-cover: {where} binds an alias that "
                             f"is not a pattern vertex")
                if not node.edges:
                    v.append(f"physical-cover: {where} has no edges")
                local = set()
                for e in node.edges:
                    check_edge(e, node.new_alias, bound, where)
                    if e.alias in used:
                        v.append(f"physical-cover: {where} re-traverses "
                                 f"edge {e.alias!r}")
                    local.add(e.alias)
                scope = bound | {node.new_alias} | local
                check_preds(vertex_preds(node.new_alias), scope, where)
                for e in node.edges:
                    check_preds(e.predicates, scope, where)
                return bound | {node.new_alias}, used | local
            if isinstance(node, ExpandChainNode):
                bound, used = walk(node.child)
                return self._check_chain(pattern, node, bound, used,
                                         pat_edges, check_edge, check_preds,
                                         vertex_preds, v)
            if isinstance(node, JoinNode):
                lb, lu = walk(node.left)
                rb, ru = walk(node.right)
                for k in node.keys:
                    if k not in lb or k not in rb:
                        v.append(f"physical-cover: Join key {k!r} is not "
                                 f"bound on both sides "
                                 f"(left={sorted(lb)}, right={sorted(rb)})")
                return lb | rb, lu | ru
            v.append(f"physical-cover: unknown physical node "
                     f"{type(node).__name__}")
            return set(), set()

        bound, used = walk(physical)
        missing_v = set(pattern.vertices) - bound
        if missing_v:
            v.append(f"physical-cover: pattern vertex alias(es) "
                     f"{sorted(missing_v)} are never bound by the plan")
        extra_v = bound - set(pattern.vertices)
        if extra_v:
            v.append(f"physical-cover: plan binds alias(es) "
                     f"{sorted(extra_v)} that are not pattern vertices")
        missing_e = set(pat_edges) - used
        if missing_e:
            v.append(f"physical-cover: pattern edge(s) "
                     f"{sorted(missing_e)} are never traversed — their "
                     f"constraints would be silently dropped")

    def _check_chain(self, pattern, node: ExpandChainNode, bound: set[str],
                     used: set[str], pat_edges, check_edge, check_preds,
                     vertex_preds, v: list[str]) -> tuple[set[str], set[str]]:
        where0 = "ExpandChain"
        if not node.steps:
            v.append(f"chain-contract: {where0} has no steps")
            return bound, used
        cur = set(bound)
        local_edges: set[str] = set()
        last = len(node.steps) - 1
        for i, s in enumerate(node.steps):
            where = f"{where0} step {i} (+{s.alias})"
            if s.from_alias not in cur:
                v.append(f"chain-contract: {where} expands from "
                         f"{s.from_alias!r} which is not bound by the "
                         f"child or an earlier step — hop discontinuity")
            if s.alias in cur:
                v.append(f"chain-contract: {where} re-binds an "
                         f"already-bound alias")
            if {s.edge.src, s.edge.dst} != {s.from_alias, s.alias}:
                v.append(f"chain-contract: {where} edge {s.edge.alias!r} "
                         f"connects ({s.edge.src!r},{s.edge.dst!r}), not "
                         f"({s.from_alias!r},{s.alias!r})")
            check_edge(s.edge, s.alias, cur, where)
            if s.edge.alias in used or s.edge.alias in local_edges:
                v.append(f"chain-contract: {where} re-traverses edge "
                         f"{s.edge.alias!r}")
            local_edges.add(s.edge.alias)
            if s.intersect_edges and i != last:
                v.append(f"chain-contract: {where} carries intersect "
                         f"edges but is not the chain's last step — the "
                         f"WCOJ tail must come last")
            for e in s.intersect_edges:
                check_edge(e, s.alias, cur | {s.alias}, f"{where} intersect")
                if e.alias in used or e.alias in local_edges:
                    v.append(f"chain-contract: {where} re-traverses "
                             f"intersect edge {e.alias!r}")
                local_edges.add(e.alias)
            cur.add(s.alias)
            scope = cur | local_edges
            check_preds(vertex_preds(s.alias), scope, where)
            for e in (s.edge, *s.intersect_edges):
                check_preds(e.predicates, scope, where)
        return cur, used | local_edges

    # --------------------------------------------------- store-level contracts
    def _check_delta_epochs(self, physical: PlanNode, v: list[str]) -> None:
        if self.store is None:
            return
        epoch = getattr(self.store, "compaction_epoch", 0)

        def rec(n):
            if isinstance(n, ExpandChainNode):
                cached = n.__dict__.get("_chain_spec")
                if cached is not None:
                    key = cached[0]
                    if key[0] == id(self.store) and key[1] != epoch:
                        v.append(
                            f"delta-epoch: chain spec memo on "
                            f"ExpandChain(+{'/'.join(s.alias for s in n.steps)})"
                            f" was compiled at compaction epoch {key[1]} "
                            f"but the store is at epoch {epoch} — stale "
                            f"CSR topology")
                rec(n.child)
            elif isinstance(n, ExpandNode):
                rec(n.child)
            elif isinstance(n, JoinNode):
                rec(n.left)
                rec(n.right)

        rec(physical)

    def _built_ops(self):
        if self.spec is None or self.store is None:
            return None
        cache = self.store.__dict__.get("_physical_ops_cache")
        if not cache:
            return None
        return cache.get(self.spec.name)

    def _check_capacities(self, v: list[str]) -> None:
        ops = self._built_ops()
        chains = getattr(ops, "_chains", None)
        if not chains:
            return
        for prog in chains.values():
            caps = getattr(prog, "caps", None)
            if caps is None:
                continue
            for c in caps:
                if c < 1 or (c & (c - 1)):
                    v.append(f"capacity-pow2: fused chain capacity "
                             f"schedule {caps} contains non-power-of-two "
                             f"bucket {c}")
                    break
            for key in getattr(prog, "_progs", {}):
                kcaps = key[0]
                if (len(kcaps) == len(caps)
                        and any(k > c for k, c in zip(kcaps, caps))):
                    v.append(f"capacity-pow2: cached chain program compiled "
                             f"for caps {kcaps} exceeds the handle's "
                             f"current caps {caps} — capacity schedule "
                             f"must grow monotonically")

    def _check_operator_contracts(self, v: list[str]) -> None:
        ops = self._built_ops()
        if ops is None:
            return
        report = ops.__dict__.get("_dtype_contract_failures")
        if report is None:
            from repro_torch.core.physical_spec import dtype_contract_failures
            report = tuple(dtype_contract_failures(ops))
            ops.__dict__["_dtype_contract_failures"] = report
        for f in report:
            v.append(f"operator-contracts: {ops.name}: {f}")
