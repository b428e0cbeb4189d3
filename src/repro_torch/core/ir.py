"""Unified intermediate representation (paper §4.1).

The IR couples a data model (Vertex/Edge/Path + primitives) with graph
operators (SCAN, EXPAND_EDGE, GET_VERTEX, EXPAND_PATH, MATCH_PATTERN) and
relational operators (SELECT, PROJECT, GROUP, ORDER, LIMIT, JOIN).  A logical
plan is a DAG of these operators; for PatRelQuery it is a chain
``MATCH_PATTERN -> relational ops`` (joins appear inside the pattern part as
physical operators chosen by the CBO).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from repro_torch.core.pattern import Pattern

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Prop:
    """alias.prop — a property of a bound vertex/edge."""
    alias: str
    name: str

    def __repr__(self):
        return f"{self.alias}.{self.name}"


@dataclasses.dataclass(frozen=True)
class Var:
    """A bound pattern alias itself (vertex/edge id column)."""
    alias: str

    def __repr__(self):
        return self.alias


@dataclasses.dataclass(frozen=True)
class Lit:
    value: Any

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Param:
    """A late-bound query parameter ``$name`` — a first-class IR node that
    survives through RBO/CBO into the physical plan and is resolved against
    the execution-time bindings (DESIGN.md §3).  ``InSet.values`` may also be
    a ``Param`` (whole-list parameter, e.g. ``x IN $S``)."""
    name: str

    def __repr__(self):
        return f"${self.name}"


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str          # = <> < > <= >=
    lhs: Any
    rhs: Any

    def __repr__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass(frozen=True)
class InSet:
    item: Any
    values: tuple

    def __repr__(self):
        return f"({self.item} IN {list(self.values)!r})"


@dataclasses.dataclass(frozen=True)
class BoolOp:
    op: str          # AND OR NOT
    args: tuple

    def __repr__(self):
        if self.op == "NOT":
            return f"(NOT {self.args[0]})"
        return "(" + f" {self.op} ".join(map(repr, self.args)) + ")"


@dataclasses.dataclass(frozen=True)
class Agg:
    fn: str          # COUNT SUM MIN MAX AVG
    arg: Any = None  # None == COUNT(*)

    def __repr__(self):
        return f"{self.fn}({self.arg if self.arg is not None else '*'})"


def expr_aliases(e) -> set[str]:
    """Pattern aliases referenced by an expression."""
    if isinstance(e, Prop):
        return {e.alias}
    if isinstance(e, Var):
        return {e.alias}
    if isinstance(e, Cmp):
        return expr_aliases(e.lhs) | expr_aliases(e.rhs)
    if isinstance(e, InSet):
        return expr_aliases(e.item)
    if isinstance(e, BoolOp):
        out: set[str] = set()
        for a in e.args:
            out |= expr_aliases(a)
        return out
    if isinstance(e, Agg):
        return expr_aliases(e.arg) if e.arg is not None else set()
    return set()


def expr_var_aliases(e) -> set[str]:
    """Aliases referenced as bare ``Var`` nodes (which the engine resolves
    against the binding table's id columns — unlike ``Prop`` references,
    which also resolve for edge aliases through the ``alias#t``/``alias#p``
    identity columns).  The ``PlanVerifier`` scopes the two differently."""
    if isinstance(e, Var):
        return {e.alias}
    if isinstance(e, Prop):
        return set()
    if isinstance(e, Cmp):
        return expr_var_aliases(e.lhs) | expr_var_aliases(e.rhs)
    if isinstance(e, InSet):
        return expr_var_aliases(e.item)
    if isinstance(e, BoolOp):
        out: set[str] = set()
        for a in e.args:
            out |= expr_var_aliases(a)
        return out
    if isinstance(e, Agg):
        return expr_var_aliases(e.arg) if e.arg is not None else set()
    return set()


def expr_props(e) -> set[Prop]:
    if isinstance(e, Prop):
        return {e}
    if isinstance(e, Cmp):
        return expr_props(e.lhs) | expr_props(e.rhs)
    if isinstance(e, InSet):
        return expr_props(e.item)
    if isinstance(e, BoolOp):
        out: set[Prop] = set()
        for a in e.args:
            out |= expr_props(a)
        return out
    if isinstance(e, Agg):
        return expr_props(e.arg) if e.arg is not None else set()
    return set()


def expr_params(e) -> set[str]:
    """Names of late-bound parameters referenced by an expression."""
    if isinstance(e, Param):
        return {e.name}
    if isinstance(e, Cmp):
        return expr_params(e.lhs) | expr_params(e.rhs)
    if isinstance(e, InSet):
        out = expr_params(e.item)
        if isinstance(e.values, Param):
            out |= {e.values.name}
        return out
    if isinstance(e, BoolOp):
        out: set[str] = set()
        for a in e.args:
            out |= expr_params(a)
        return out
    if isinstance(e, Agg):
        return expr_params(e.arg) if e.arg is not None else set()
    return set()


def subst_aliases(e, mapping: dict):
    """Rewrite an expression with pattern aliases renamed via ``mapping``
    (expressions are immutable; returns a new node where needed)."""
    if isinstance(e, Prop):
        return Prop(mapping.get(e.alias, e.alias), e.name)
    if isinstance(e, Var):
        return Var(mapping.get(e.alias, e.alias))
    if isinstance(e, Cmp):
        return Cmp(e.op, subst_aliases(e.lhs, mapping),
                   subst_aliases(e.rhs, mapping))
    if isinstance(e, InSet):
        return InSet(subst_aliases(e.item, mapping), e.values)
    if isinstance(e, BoolOp):
        return BoolOp(e.op, tuple(subst_aliases(a, mapping) for a in e.args))
    if isinstance(e, Agg):
        return Agg(e.fn, subst_aliases(e.arg, mapping)
                   if e.arg is not None else None)
    return e


def conjuncts(e) -> list:
    """Split a predicate into AND-conjuncts."""
    if isinstance(e, BoolOp) and e.op == "AND":
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def make_and(parts: Sequence) -> Any:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return BoolOp("AND", tuple(parts))


# --------------------------------------------------------------------------
# Logical operators
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Op:
    """Base logical operator."""


@dataclasses.dataclass
class Scan(Op):
    alias: str
    types: frozenset
    elem: str = "V"                     # V | E
    predicate: Any = None               # fused filter (FilterIntoMatchRule)
    columns: Optional[frozenset] = None  # needed props (FieldTrimRule)


@dataclasses.dataclass
class ExpandEdge(Op):
    tag: str
    alias: str
    labels: frozenset
    direction: str                      # OUT | IN | BOTH
    predicate: Any = None
    columns: Optional[frozenset] = None


@dataclasses.dataclass
class GetVertex(Op):
    tag: str
    alias: str
    types: frozenset
    endpoint: str                       # SOURCE | TARGET | OTHER
    predicate: Any = None
    columns: Optional[frozenset] = None


@dataclasses.dataclass
class ExpandFused(Op):
    """EXPAND_EDGE+GET_VERTEX fused by ExpandGetVFusionRule."""
    tag: str
    edge_alias: str
    alias: str
    labels: frozenset
    types: frozenset
    direction: str
    predicate: Any = None
    columns: Optional[frozenset] = None


@dataclasses.dataclass
class ExpandPath(Op):
    tag: str
    alias: str
    labels: frozenset
    direction: str
    hops: int


@dataclasses.dataclass
class MatchPattern(Op):
    """Composite operator MATCH_START..MATCH_END; semantically the Pattern."""
    pattern: Pattern


@dataclasses.dataclass
class Select(Op):
    predicate: Any


@dataclasses.dataclass
class Project(Op):
    items: list                          # [(expr, out_name)]
    distinct: bool = False


@dataclasses.dataclass
class GroupBy(Op):
    keys: list                           # [(expr, out_name)]
    aggs: list                           # [(Agg, out_name)]


@dataclasses.dataclass
class OrderBy(Op):
    items: list                          # [(expr, ascending)]
    limit: Optional[int] = None


@dataclasses.dataclass
class Limit(Op):
    n: int


@dataclasses.dataclass
class LogicalPlan:
    """Chain of operators (MATCH first, relational after)."""
    ops: list
    params: dict = dataclasses.field(default_factory=dict)
    hints: dict = dataclasses.field(default_factory=dict)

    def pattern(self) -> Optional[Pattern]:
        for op in self.ops:
            if isinstance(op, MatchPattern):
                return op.pattern
        return None

    def replace_pattern(self, pattern: Pattern) -> None:
        for i, op in enumerate(self.ops):
            if isinstance(op, MatchPattern):
                self.ops[i] = MatchPattern(pattern)
                return
        raise ValueError("plan has no MATCH_PATTERN")

    def copy(self) -> "LogicalPlan":
        """Deep-enough copy: pattern and op list are fresh (expressions are
        immutable and shared)."""
        ops = []
        for op in self.ops:
            if isinstance(op, MatchPattern):
                ops.append(MatchPattern(op.pattern.copy()))
            elif isinstance(op, Project):
                ops.append(Project(list(op.items), op.distinct))
            elif isinstance(op, GroupBy):
                ops.append(GroupBy(list(op.keys), list(op.aggs)))
            elif isinstance(op, OrderBy):
                ops.append(OrderBy(list(op.items), op.limit))
            else:
                ops.append(dataclasses.replace(op))
        return LogicalPlan(ops, dict(self.params), dict(self.hints))

    def referenced_params(self) -> set[str]:
        """Every ``$param`` referenced by an expression anywhere in the plan
        (relational ops and predicates pushed into the pattern)."""
        out: set[str] = set()
        for op in self.ops:
            if isinstance(op, MatchPattern):
                for v in op.pattern.vertices.values():
                    for p in v.predicates:
                        out |= expr_params(p)
                for e in op.pattern.edges:
                    for p in e.predicates:
                        out |= expr_params(p)
            elif isinstance(op, Select):
                out |= expr_params(op.predicate)
            elif isinstance(op, Project):
                for e, _ in op.items:
                    out |= expr_params(e)
            elif isinstance(op, GroupBy):
                for e, _ in op.keys:
                    out |= expr_params(e)
                for a, _ in op.aggs:
                    out |= expr_params(a)
            elif isinstance(op, OrderBy):
                for e, _ in op.items:
                    out |= expr_params(e)
        return out

    def declared_params(self) -> set[str]:
        """Referenced params plus everything bound at build time (including
        structural params consumed during parsing, e.g. hop counts)."""
        return self.referenced_params() | set(self.params)

    def snapshot(self) -> list[str]:
        """Deterministic one-line-per-op serialization (the canonical form
        split into lines) — what optimizer passes diff before/after to
        record plan changes in their ``PassTrace``."""
        return canonical_form(self).split("\n")

    def __repr__(self):
        return "LogicalPlan[\n  " + "\n  ".join(map(repr, self.ops)) + "\n]"


# --------------------------------------------------------------------------
# Canonical form (normalized GIR)
# --------------------------------------------------------------------------


def _ser_expr(e, ren) -> str:
    """Deterministic serialization of an expression with aliases renamed
    through ``ren`` and commutative boolean args sorted."""
    if isinstance(e, Prop):
        return f"{ren(e.alias)}.{e.name}"
    if isinstance(e, Var):
        return ren(e.alias)
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Param):
        return f"${e.name}"
    if isinstance(e, Cmp):
        return f"({_ser_expr(e.lhs, ren)} {e.op} {_ser_expr(e.rhs, ren)})"
    if isinstance(e, InSet):
        vals = (f"${e.values.name}" if isinstance(e.values, Param)
                else repr(list(e.values)))
        return f"({_ser_expr(e.item, ren)} IN {vals})"
    if isinstance(e, BoolOp):
        args = [_ser_expr(a, ren) for a in e.args]
        if e.op in ("AND", "OR"):
            args = sorted(args)
        return "(" + e.op + " " + " ".join(args) + ")"
    if isinstance(e, Agg):
        arg = _ser_expr(e.arg, ren) if e.arg is not None else "*"
        return f"{e.fn}({arg})"
    return repr(e)


def canonical_form(plan: LogicalPlan) -> str:
    """A normalized, hashable serialization of the GIR.

    Used (a) as the prepared-plan cache key — two queries that lower to the
    same GIR share one optimized plan — and (b) for frontend-parity checks:
    the Cypher parser and the Gremlin builder must produce identical
    canonical forms for equivalent queries.  Anonymous aliases (the
    ``_``-prefixed ones minted by ``GraphIrBuilder``) are relabeled by order
    of first structural appearance so frontends' fresh-name counters do not
    leak into the form.  Late-bound ``Param`` nodes serialize by name, so the
    form is independent of any binding values."""
    pattern = plan.pattern()
    order: list[str] = []

    def note(a: str):
        if a.startswith("_") and a not in order:
            order.append(a)

    if pattern is not None:
        for e in pattern.edges:
            note(e.src)
            note(e.dst)
            note(e.alias)
        for a in sorted(pattern.vertices):
            note(a)
    rename = {a: f"_c{i}" for i, a in enumerate(order)}

    def ren(a: str) -> str:
        return rename.get(a, a)

    parts: list[str] = []
    for op in plan.ops:
        if isinstance(op, MatchPattern):
            p = op.pattern
            vs = sorted(
                f"({ren(a)}:{'|'.join(sorted(v.types))}"
                + ("" if not v.predicates else
                   "{" + ",".join(sorted(_ser_expr(q, ren)
                                         for q in v.predicates)) + "}")
                + ")"
                for a, v in p.vertices.items())
            es = sorted(
                f"{ren(e.src)}-[{ren(e.alias)}:"
                f"{'|'.join(sorted(map(repr, e.triples)))}"
                f":{e.direction}*{e.hops}"
                + ("" if not e.predicates else
                   "{" + ",".join(sorted(_ser_expr(q, ren)
                                         for q in e.predicates)) + "}")
                + f"]-{ren(e.dst)}"
                for e in p.edges)
            parts.append("MATCH[" + ";".join(vs) + "|" + ";".join(es) + "]")
        elif isinstance(op, Select):
            cs = sorted(_ser_expr(c, ren) for c in conjuncts(op.predicate))
            parts.append("SELECT[" + " AND ".join(cs) + "]")
        elif isinstance(op, Project):
            items = ",".join(f"{_ser_expr(e, ren)} AS {n}"
                             for e, n in op.items)
            parts.append(f"PROJECT[{items}|distinct={op.distinct}]")
        elif isinstance(op, GroupBy):
            ks = ",".join(f"{_ser_expr(e, ren)} AS {n}" for e, n in op.keys)
            ags = ",".join(f"{_ser_expr(a, ren)} AS {n}" for a, n in op.aggs)
            parts.append(f"GROUP[{ks}|{ags}]")
        elif isinstance(op, OrderBy):
            items = ",".join(f"{_ser_expr(e, ren)}:{'A' if asc else 'D'}"
                             for e, asc in op.items)
            parts.append(f"ORDER[{items}|limit={op.limit}]")
        elif isinstance(op, Limit):
            parts.append(f"LIMIT[{op.n}]")
        else:
            parts.append(repr(op))
    return "\n".join(parts)
