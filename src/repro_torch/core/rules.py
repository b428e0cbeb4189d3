"""Rule-based optimization (paper §5.2, §6).

Hep-style driver: each rule is (condition, action) over the LogicalPlan;
rules are applied repeatedly until a fixpoint. Implemented rules:

- FilterIntoMatchRule  (graph-relational interplay): single-alias conjuncts of
  SELECT move into the pattern vertex/edge predicate lists, so the engine
  filters during expansion.
- FieldTrimRule        (relational): computes which aliases/properties are
  live downstream and records them on the plan (`plan.hints['live']`); the
  engine then never materializes or ships dead columns.
- ExpandGetVFusionRule (graph): marks EXPAND_EDGE+GET_VERTEX fusable unless a
  downstream operator needs standalone edge processing
  (`plan.hints['fuse_expand']`).
- OrderLimitFuseRule   (relational): ORDER BY followed by LIMIT becomes a
  top-k OrderBy (partial sort in the engine).

``DEFAULT_RULES`` is the paper's historical rule set (frozen — the parity
baseline); ``EXTENDED_RULES`` (ConstantFoldingRule,
RedundantSelectMergeRule) ride the OptimizerPipeline registration seam
(core/pipeline.py) instead of being hand-woven into the driver.  The
``apply_rules`` fixpoint driver remains for direct/legacy use; the default
pipeline runs every rule in its rbo fixpoint group with per-rule traces.
"""
from __future__ import annotations

import operator

from repro_torch.core import ir


class Rule:
    name = "rule"

    def apply(self, plan: ir.LogicalPlan) -> bool:
        """Mutates plan; returns True if anything changed."""
        raise NotImplementedError


class FilterIntoMatchRule(Rule):
    name = "FilterIntoMatchRule"

    def apply(self, plan: ir.LogicalPlan) -> bool:
        pattern = plan.pattern()
        if pattern is None:
            return False
        changed = False
        new_ops = []
        for op in plan.ops:
            if not isinstance(op, ir.Select):
                new_ops.append(op)
                continue
            keep = []
            for c in ir.conjuncts(op.predicate):
                aliases = ir.expr_aliases(c)
                if len(aliases) != 1:
                    keep.append(c)
                    continue
                a = next(iter(aliases))
                if a in pattern.vertices:
                    pattern.vertices[a].predicates.append(c)
                    changed = True
                    continue
                edge = next((e for e in pattern.edges if e.alias == a), None)
                if edge is not None:
                    edge.predicates.append(c)
                    changed = True
                    continue
                keep.append(c)
            pred = ir.make_and(keep)
            if pred is not None:
                new_ops.append(ir.Select(pred))
        if changed:
            plan.ops[:] = new_ops
        return changed


class FieldTrimRule(Rule):
    name = "FieldTrimRule"

    def apply(self, plan: ir.LogicalPlan) -> bool:
        pattern = plan.pattern()
        if pattern is None:
            return False
        live_aliases: set[str] = set()
        live_props: set[tuple[str, str]] = set()

        def visit(e):
            live_aliases.update(ir.expr_aliases(e))
            for p in ir.expr_props(e):
                live_props.add((p.alias, p.name))

        for op in plan.ops:
            if isinstance(op, ir.Select):
                visit(op.predicate)
            elif isinstance(op, ir.Project):
                for e, _ in op.items:
                    visit(e)
            elif isinstance(op, ir.GroupBy):
                for e, _ in op.keys:
                    visit(e)
                for a, _ in op.aggs:
                    visit(a)
            elif isinstance(op, ir.OrderBy):
                for e, _ in op.items:
                    visit(e)
        # pattern-internal predicates (already pushed) count as live too
        for v in pattern.vertices.values():
            for p in v.predicates:
                visit(p)
        for e in pattern.edges:
            for p in e.predicates:
                visit(p)
        new = {"aliases": frozenset(live_aliases),
               "props": frozenset(live_props)}
        if plan.hints.get("live") == new:
            return False
        plan.hints["live"] = new
        return True


class ExpandGetVFusionRule(Rule):
    name = "ExpandGetVFusionRule"

    def apply(self, plan: ir.LogicalPlan) -> bool:
        if "fuse_expand" in plan.hints:
            return False
        # Fusion is legal unless some downstream op needs the edge as a
        # standalone row stream; with binding tables we can always fuse.
        plan.hints["fuse_expand"] = True
        return True


class OrderLimitFuseRule(Rule):
    name = "OrderLimitFuseRule"

    def apply(self, plan: ir.LogicalPlan) -> bool:
        ops = plan.ops
        for i in range(len(ops) - 1):
            if (isinstance(ops[i], ir.OrderBy) and ops[i].limit is None
                    and isinstance(ops[i + 1], ir.Limit)):
                ops[i].limit = ops[i + 1].n
                del ops[i + 1]
                return True
        return False


class ConstantFoldingRule(Rule):
    """Fold constant sub-expressions in predicates (SELECT ops and the
    predicates already pushed into pattern vertices/edges): ``Cmp``/``InSet``
    over literals become ``Lit(True/False)``, booleans simplify (AND drops
    True / collapses on False, OR dually, NOT inverts).  A tautological
    filter disappears; a contradiction stays as ``Select(Lit(False))`` so
    the engine short-circuits to zero rows."""

    name = "ConstantFoldingRule"

    @classmethod
    def fold(cls, e):
        if isinstance(e, ir.Cmp):
            lhs, rhs = cls.fold(e.lhs), cls.fold(e.rhs)
            if isinstance(lhs, ir.Lit) and isinstance(rhs, ir.Lit):
                ops = {"=": operator.eq, "<>": operator.ne,
                       "<": operator.lt, ">": operator.gt,
                       "<=": operator.le, ">=": operator.ge}
                try:
                    return ir.Lit(bool(ops[e.op](lhs.value, rhs.value)))
                except TypeError:
                    pass                      # incomparable literals
            if lhs is e.lhs and rhs is e.rhs:
                return e
            return ir.Cmp(e.op, lhs, rhs)
        if isinstance(e, ir.InSet):
            item = cls.fold(e.item)
            if isinstance(item, ir.Lit) and not isinstance(e.values, ir.Param):
                return ir.Lit(item.value in e.values)
            if item is e.item:
                return e
            return ir.InSet(item, e.values)
        if isinstance(e, ir.BoolOp):
            args = tuple(cls.fold(a) for a in e.args)
            if e.op == "NOT":
                if isinstance(args[0], ir.Lit):
                    return ir.Lit(not args[0].value)
                return e if args[0] is e.args[0] else ir.BoolOp("NOT", args)
            dominant = e.op == "OR"           # True dominates OR, False AND
            keep = []
            for a in args:
                if isinstance(a, ir.Lit) and isinstance(a.value, bool):
                    if a.value == dominant:
                        return ir.Lit(dominant)
                    continue                  # neutral element: drop
                keep.append(a)
            if not keep:
                return ir.Lit(not dominant)
            if len(keep) == 1:
                return keep[0]
            if tuple(keep) == e.args:
                return e
            return ir.BoolOp(e.op, tuple(keep))
        return e

    def apply(self, plan: ir.LogicalPlan) -> bool:
        changed = False
        new_ops = []
        for op in plan.ops:
            if isinstance(op, ir.Select):
                folded = self.fold(op.predicate)
                # NB: check the folded *value*, not object identity — a
                # predicate that already IS Lit(True) must still be dropped
                # (and report changed, honoring the fixpoint contract)
                if isinstance(folded, ir.Lit) and folded.value is True:
                    changed = True
                    continue                  # tautology: drop the filter
                if folded is not op.predicate:
                    changed = True
                    op = ir.Select(folded)
            new_ops.append(op)
        pattern = plan.pattern()
        if pattern is not None:
            elems = list(pattern.vertices.values()) + list(pattern.edges)
            for el in elems:
                kept = []
                for p in el.predicates:
                    folded = self.fold(p)
                    if isinstance(folded, ir.Lit) and folded.value is True:
                        changed = True
                        continue
                    if folded is not p:
                        changed = True
                    kept.append(folded)
                el.predicates[:] = kept
        if changed:
            plan.ops[:] = new_ops
        return changed


class RedundantSelectMergeRule(Rule):
    """Merge consecutive SELECT ops into one and drop duplicate conjuncts
    (expressions are frozen dataclasses, so equality is structural).  Keeps
    conjunct order stable for deterministic canonical forms."""

    name = "RedundantSelectMergeRule"

    @staticmethod
    def _dedup(conjs: list) -> list:
        seen = set()
        out = []
        for c in conjs:
            if c not in seen:
                seen.add(c)
                out.append(c)
        return out

    def apply(self, plan: ir.LogicalPlan) -> bool:
        changed = False
        new_ops: list = []
        for op in plan.ops:
            if (isinstance(op, ir.Select) and new_ops
                    and isinstance(new_ops[-1], ir.Select)):
                merged = self._dedup(ir.conjuncts(new_ops[-1].predicate)
                                     + ir.conjuncts(op.predicate))
                new_ops[-1] = ir.Select(ir.make_and(merged))
                changed = True
                continue
            if isinstance(op, ir.Select):
                conjs = ir.conjuncts(op.predicate)
                deduped = self._dedup(conjs)
                if len(deduped) != len(conjs):
                    op = ir.Select(ir.make_and(deduped))
                    changed = True
            new_ops.append(op)
        if changed:
            plan.ops[:] = new_ops
        return changed


DEFAULT_RULES: tuple[Rule, ...] = (
    FilterIntoMatchRule(),
    FieldTrimRule(),
    ExpandGetVFusionRule(),
    OrderLimitFuseRule(),
)

# Rules that ride the OptimizerPipeline's registration seam rather than the
# historical frozen driver list: the default pipeline registers these after
# DEFAULT_RULES (core/pipeline.py), proving the rbo phase carries rules that
# were never hand-woven into GOpt.optimize.
EXTENDED_RULES: tuple[Rule, ...] = (
    ConstantFoldingRule(),
    RedundantSelectMergeRule(),
)


def apply_rules(plan: ir.LogicalPlan, rules=DEFAULT_RULES,
                max_iters: int = 10) -> ir.LogicalPlan:
    """HepPlanner-style fixpoint application. Mutates and returns plan."""
    for _ in range(max_iters):
        changed = False
        for r in rules:
            changed |= r.apply(plan)
        if not changed:
            break
    return plan
