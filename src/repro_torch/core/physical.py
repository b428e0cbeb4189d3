"""Physical pattern-plan algebra (paper §5.3.1).

The CBO decomposes a PATTERN into a tree over two physical operators:

- ``Expand({p_s, +v} -> p_t)`` — vertex expansion; with one edge it's a simple
  neighbor expansion, with several it is the *expand-and-intersect* step of a
  worst-case-optimal join;
- ``Join({p_s1, p_s2} -> p_t)`` — binary pattern join on the common vertices
  (PatternJoinRule, Eq. 1).

Leaf = Scan of a single pattern vertex. Nodes carry the estimated frequency
and accumulated cost so plans are inspectable in benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import ir
from repro_torch.core.pattern import Pattern, PatternEdge


@dataclasses.dataclass
class PlanNode:
    est_frequency: float = dataclasses.field(default=0.0, kw_only=True)
    est_cost: float = dataclasses.field(default=0.0, kw_only=True)

    def bound_aliases(self) -> frozenset[str]:
        raise NotImplementedError

    def pretty(self, indent: int = 0) -> str:
        raise NotImplementedError


@dataclasses.dataclass
class ScanNode(PlanNode):
    alias: str

    def bound_aliases(self) -> frozenset[str]:
        return frozenset({self.alias})

    def pretty(self, indent=0):
        pad = "  " * indent
        return (f"{pad}Scan({self.alias}) "
                f"[F={self.est_frequency:.3g} C={self.est_cost:.3g}]")


@dataclasses.dataclass
class ExpandNode(PlanNode):
    child: PlanNode
    new_alias: str
    edges: list[PatternEdge]   # all pattern edges new_alias<->bound vertices

    def bound_aliases(self) -> frozenset[str]:
        return self.child.bound_aliases() | {self.new_alias}

    def pretty(self, indent=0):
        pad = "  " * indent
        kind = "ExpandIntersect" if len(self.edges) > 1 else "Expand"
        es = ",".join(f"{e.src}->{e.dst}" for e in self.edges)
        return (f"{pad}{kind}(+{self.new_alias} via {es}) "
                f"[F={self.est_frequency:.3g} C={self.est_cost:.3g}]\n"
                + self.child.pretty(indent + 1))


@dataclasses.dataclass
class JoinNode(PlanNode):
    left: PlanNode
    right: PlanNode
    keys: tuple[str, ...]

    def bound_aliases(self) -> frozenset[str]:
        return self.left.bound_aliases() | self.right.bound_aliases()

    def pretty(self, indent=0):
        pad = "  " * indent
        return (f"{pad}Join(keys={list(self.keys)}) "
                f"[F={self.est_frequency:.3g} C={self.est_cost:.3g}]\n"
                + self.left.pretty(indent + 1) + "\n"
                + self.right.pretty(indent + 1))


@dataclasses.dataclass
class ChainStep:
    """One hop of an ``ExpandChainNode``: expand ``from_alias`` along
    ``edge`` to bind ``alias``.  Carries the per-hop estimates of the
    ``ExpandNode`` it was fused from, so ``unfused()`` round-trips.

    ``intersect_edges`` (only ever non-empty on a chain's *last* step) are
    the extra edges of a fused expand-and-intersect: after the expansion
    the step probes each of them as a WCOJ membership filter, exactly like
    a multi-edge ``ExpandNode`` — the chain then ends in a wcoj step."""
    edge: PatternEdge
    from_alias: str
    alias: str
    est_frequency: float = 0.0
    est_cost: float = 0.0
    intersect_edges: tuple = ()

    def all_edges(self) -> list[PatternEdge]:
        return [self.edge, *self.intersect_edges]


@dataclasses.dataclass
class ExpandChainNode(PlanNode):
    """A fused run of consecutive single-edge expansions (backend physical
    rewrite, DESIGN.md §6.2): the engine expands a *thin* frontier table
    (hop columns only) hop-by-hop and gathers the full binding table once
    at the end, instead of round-tripping every bound column through the
    host at every hop.  Only predicate-free hops are fusable — deferring a
    filter past a hop would change intermediate semantics."""
    child: PlanNode
    steps: list[ChainStep]

    def bound_aliases(self) -> frozenset[str]:
        return self.child.bound_aliases() | {s.alias for s in self.steps}

    def unfused(self) -> PlanNode:
        """The equivalent nested-``ExpandNode`` chain (the pre-fusion
        plan) — used by the engine's fuse ablation and by parity checks."""
        node = self.child
        for s in self.steps:
            node = ExpandNode(node, s.alias, s.all_edges(),
                              est_frequency=s.est_frequency,
                              est_cost=s.est_cost)
        return node

    def pretty(self, indent=0):
        pad = "  " * indent
        hops = ",".join(f"+{s.alias}" + (f"x{1 + len(s.intersect_edges)}"
                                         if s.intersect_edges else "")
                        for s in self.steps)
        return (f"{pad}ExpandChain({hops}) "
                f"[F={self.est_frequency:.3g} C={self.est_cost:.3g}]\n"
                + self.child.pretty(indent + 1))


def plan_signature(node: PlanNode) -> str:
    """Stable string for logging/plan comparison."""
    if isinstance(node, ScanNode):
        return f"S({node.alias})"
    if isinstance(node, ExpandNode):
        return f"E({plan_signature(node.child)},+{node.new_alias}x{len(node.edges)})"
    if isinstance(node, JoinNode):
        return (f"J({plan_signature(node.left)},{plan_signature(node.right)},"
                f"k={'/'.join(node.keys)})")
    if isinstance(node, ExpandChainNode):
        hops = "".join(f",+{s.alias}x{1 + len(s.intersect_edges)}"
                       if s.intersect_edges else f",+{s.alias}"
                       for s in node.steps)
        return f"C({plan_signature(node.child)}{hops})"
    raise TypeError(node)


def unfuse_chains(node: PlanNode) -> PlanNode:
    """Normalize a plan by unfolding every ``ExpandChainNode`` back into
    nested expansions — chain fusion is packaging, not a different join
    order, so parity checks compare plans modulo fusion through this."""
    if isinstance(node, ExpandChainNode):
        return unfuse_chains(node.unfused())
    if isinstance(node, ExpandNode):
        return dataclasses.replace(node, child=unfuse_chains(node.child))
    if isinstance(node, JoinNode):
        return dataclasses.replace(node, left=unfuse_chains(node.left),
                                   right=unfuse_chains(node.right))
    return node


def plan_children(node: PlanNode) -> list[PlanNode]:
    if isinstance(node, ExpandNode):
        return [node.child]
    if isinstance(node, ExpandChainNode):
        return [node.child]
    if isinstance(node, JoinNode):
        return [node.left, node.right]
    return []


def plan_operators(node: PlanNode) -> list[PlanNode]:
    """All operators of a pattern plan in execution (post-)order — the
    order the engine logs their actual row counts in ``ExecStats``."""
    out: list[PlanNode] = []

    def rec(n: PlanNode):
        for c in plan_children(n):
            rec(c)
        out.append(n)

    rec(node)
    return out


def describe_node(node: PlanNode) -> str:
    """Short human-readable operator label for EXPLAIN output."""
    if isinstance(node, ScanNode):
        return f"Scan({node.alias})"
    if isinstance(node, ExpandNode):
        kind = "ExpandIntersect" if len(node.edges) > 1 else "Expand"
        return f"{kind}(+{node.new_alias}|{len(node.edges)}e)"
    if isinstance(node, JoinNode):
        return f"Join(keys={list(node.keys)})"
    if isinstance(node, ExpandChainNode):
        hops = "".join(f"+{s.alias}" for s in node.steps)
        return f"ExpandChain({hops})"
    raise TypeError(node)


# --------------------------------------------------------------------------
# Chain-fusable predicates (DESIGN.md §8)
# --------------------------------------------------------------------------
# A hop predicate can fold into a fused ExpandChainNode program when it is a
# boolean combination of comparisons / IN-set probes whose column side reads
# an alias the thin chain frontier carries and whose value side is a literal
# or a late-bound parameter.  ``compile_chain_predicate`` turns such a
# predicate into (a) a hashable *static* signature — part of the fused
# program's compile-cache key, shared across literal/parameter values — and
# (b) runtime *slot* descriptors the engine evaluates per execution (value
# encoding, parameter resolution), so rebinding a parameter never recompiles.

_I32_LO, _I32_HI = -(1 << 31), (1 << 31) - 1


def _chain_value_ok(v) -> bool:
    """Literal values the int32-staged fused program can honor: in-envelope
    integers, or strings (encoded to ints at slot evaluation).  Anything
    else is rejected *statically* so the hop stays on the plain path
    instead of fusing and then falling back on every execution."""
    if isinstance(v, str):
        return True
    return (not isinstance(v, bool) and isinstance(v, int)
            and _I32_LO < v <= _I32_HI)


def _chain_col_ref(e, vertex_aliases, edge_aliases):
    if isinstance(e, ir.Var) and e.alias in vertex_aliases:
        return ("col", e.alias)
    if isinstance(e, ir.Prop):
        if e.alias in vertex_aliases:
            return ("vprop", e.alias, e.name)
        if e.alias in edge_aliases:
            return ("eprop", e.alias, e.name)
    return None


def compile_chain_predicate(expr, vertex_aliases, edge_aliases, slots):
    """Compile one pattern predicate into its chain-fusable form.

    Returns the static signature (appending runtime slot descriptors —
    ``("scalar", lhs_expr, rhs_expr)`` or ``("values", item_expr, values)``
    — to ``slots``), or ``None`` when the predicate falls outside the
    fusable subset; the caller then leaves the hop to the per-hop loop."""
    if isinstance(expr, ir.Cmp):
        ref = _chain_col_ref(expr.lhs, vertex_aliases, edge_aliases)
        if ref is None or not isinstance(expr.rhs, (ir.Lit, ir.Param)):
            return None
        if isinstance(expr.rhs, ir.Lit) and not _chain_value_ok(
                expr.rhs.value):
            return None
        slots.append(("scalar", expr.lhs, expr.rhs))
        return ("cmp", expr.op, ref, len(slots) - 1)
    if isinstance(expr, ir.InSet):
        ref = _chain_col_ref(expr.item, vertex_aliases, edge_aliases)
        if ref is None:
            return None
        if not isinstance(expr.values, ir.Param) and not all(
                _chain_value_ok(v) for v in expr.values):
            return None
        slots.append(("values", expr.item, expr.values))
        return ("in", ref, len(slots) - 1)
    if isinstance(expr, ir.BoolOp):
        subs = tuple(compile_chain_predicate(a, vertex_aliases, edge_aliases,
                                             slots)
                     for a in expr.args)
        if any(s is None for s in subs):
            return None
        return (expr.op.lower(), subs)
    return None


def chain_fusable_predicates(preds, vertex_aliases, edge_aliases) -> bool:
    """True when every predicate in ``preds`` compiles to chain-fusable
    form — the fusion rule's gate for folding a predicated hop."""
    scratch: list = []
    return all(
        compile_chain_predicate(p, vertex_aliases, edge_aliases, scratch)
        is not None for p in preds or [])


def _component_left_deep(pattern: Pattern,
                         start: str) -> tuple[PlanNode, set[str]]:
    """Left-deep expansion of ``start``'s connected component."""
    node: PlanNode = ScanNode(start)
    bound = {start}
    while True:
        nxt = None
        for b in sorted(bound):
            for e in pattern.adjacent(b):
                o = e.other(b)
                if o not in bound:
                    nxt = o
                    break
            if nxt:
                break
        if nxt is None:
            return node, bound
        edges = [e for e in pattern.adjacent(nxt) if e.other(nxt) in bound]
        node = ExpandNode(node, nxt, edges)
        bound.add(nxt)


def default_left_deep_plan(pattern: Pattern,
                           start: Optional[str] = None) -> PlanNode:
    """A naive left-deep expansion plan in BFS alias order — the engine's
    fallback when no CBO plan is supplied, and the 'unoptimized' baseline.

    A disconnected pattern becomes one left-deep plan per connected
    component, combined with keyless Joins (cross products)."""
    aliases = sorted(pattern.vertices)
    if not aliases:
        raise ValueError("cannot plan an empty pattern")
    start = start or aliases[0]
    node, bound = _component_left_deep(pattern, start)
    while bound != set(aliases):
        nxt = next(a for a in aliases if a not in bound)
        right, rbound = _component_left_deep(pattern, nxt)
        node = JoinNode(node, right, ())
        bound |= rbound
    return node
