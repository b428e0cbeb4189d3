"""Cost-based graph optimizer (paper §5.3.4, Algorithm 2).

Top-down recursive search over connected induced sub-patterns with
branch-and-bound pruning, seeded by a greedy initial plan. Physical algebra:
vertex Expand (simple / expand-and-intersect == WCOJ) and binary pattern Join
(PatternJoinRule). Cost model Eq. 2/3 plus the intermediate-result term
(communication cost):

    cost'(Expand) = cost(p_s) + F(p_t) + F(p_s) * sum(sigma_e)     (Eq. 3)
    cost'(Join)   = cost(p_s1) + cost(p_s2) + F(p_t) + F(p_s1) + F(p_s2)

Also provides the paper's experimental foils: random valid plans and a
"low-order" baseline optimizer (Neo4j-style: independence assumption, no
GLogue, no WCOJ intersections — greedy single-edge expansions only).
"""
from __future__ import annotations

import dataclasses
import itertools
import random

from repro_torch.core.cardinality import CardEstimator
from repro_torch.core.pattern import Pattern
from repro_torch.core.physical import (ExpandChainNode, ExpandNode, JoinNode,
                                 PlanNode, ScanNode, plan_signature)
from repro_torch.core.physical_spec import CostParams, PhysicalSpec, get_spec


@dataclasses.dataclass
class _Best:
    plan: PlanNode | None
    cost: float


class GraphOptimizer:
    """Algorithm 2 over the alias-subset lattice of a pattern."""

    def __init__(self, est: CardEstimator, enable_join: bool = True,
                 enable_intersect: bool = True,
                 alpha_expand: float | None = None,
                 alpha_join: float | None = None,
                 alpha_intersect: float | None = None,
                 alpha_scan: float | None = None,
                 alpha_exchange: float | None = None,
                 spec: str | PhysicalSpec | None = None):
        """Cost weights default to the active backend's ``CostParams``
        (``spec``, a PhysicalSpec or backend name); explicit ``alpha_*``
        keyword arguments override the spec values."""
        self.est = est
        self.enable_join = enable_join
        self.enable_intersect = enable_intersect
        cost = get_spec(spec).cost if spec is not None else CostParams()
        self.alpha_scan = cost.alpha_scan if alpha_scan is None else alpha_scan
        self.alpha_expand = (cost.alpha_expand if alpha_expand is None
                             else alpha_expand)
        self.alpha_intersect = (cost.alpha_intersect if alpha_intersect is None
                                else alpha_intersect)
        self.alpha_join = cost.alpha_join if alpha_join is None else alpha_join
        self.alpha_exchange = (cost.alpha_exchange if alpha_exchange is None
                               else alpha_exchange)
        self.stats = {"explored": 0, "pruned": 0}

    # ------------------------------------------------------------- interface
    def optimize(self, pattern: Pattern) -> PlanNode:
        full = frozenset(pattern.vertices)
        init = self.greedy_initial(pattern)
        self._bound = init.est_cost          # cost* from GreedyInitial
        self._plan_map: dict[frozenset[str], _Best] = {}
        # seed PlanMap with single vertices (precomputed sizes 1 & 2 — size-2
        # plans emerge from a Scan+Expand, so seeding scans suffices)
        for a in pattern.vertices:
            f = self.est.vertex_freq(pattern, a)
            c = self.alpha_scan * f
            self._plan_map[frozenset({a})] = _Best(
                ScanNode(a, est_frequency=f, est_cost=c), c)
        self._search(pattern, full)
        out = self._plan_map[full].plan
        if out is None or init.est_cost < self._plan_map[full].cost:
            return init
        return out

    # --------------------------------------------------------------- greedy
    def greedy_initial(self, pattern: Pattern) -> PlanNode:
        """GreedyInitial: cheapest-next-extension from the cheapest vertex.

        A disconnected pattern (no expandable candidate left) attaches the
        next component via a keyless cross-product Join and keeps going."""
        aliases = set(pattern.vertices)
        start = min(aliases, key=lambda a: self.est.vertex_freq(pattern, a))
        f = self.est.vertex_freq(pattern, start)
        node: PlanNode = ScanNode(start, est_frequency=f,
                                  est_cost=self.alpha_scan * f)
        bound = {start}
        while bound != aliases:
            best_alias, best_cost = None, None
            for cand in sorted(aliases - bound):
                edges = [e for e in pattern.adjacent(cand)
                         if e.other(cand) in bound]
                if not edges:
                    continue
                step_cost, f_new = self._expand_cost(
                    pattern, frozenset(bound), node.est_frequency, cand, edges)
                if best_cost is None or step_cost + f_new < best_cost:
                    best_alias, best_cost = cand, step_cost + f_new
                    best_edges, best_f, best_step = edges, f_new, step_cost
            if best_alias is None:   # next connected component
                nxt = min(aliases - bound,
                          key=lambda a: self.est.vertex_freq(pattern, a))
                fs = self.est.vertex_freq(pattern, nxt)
                scan = ScanNode(nxt, est_frequency=fs,
                                est_cost=self.alpha_scan * fs)
                fx = node.est_frequency * fs   # cross product is exact
                node = JoinNode(
                    node, scan, (), est_frequency=fx,
                    est_cost=(node.est_cost + scan.est_cost + fx +
                              (self.alpha_join + self.alpha_exchange)
                              * (node.est_frequency + fs)))
                bound.add(nxt)
                continue
            node = ExpandNode(node, best_alias, best_edges,
                              est_frequency=best_f,
                              est_cost=node.est_cost + best_step + best_f)
            bound.add(best_alias)
        return node

    def _expand_cost(self, pattern, bound: frozenset[str], f_src: float,
                     new_alias: str, edges) -> tuple[float, float]:
        """(operator cost Eq.3, F(p_t) via Eq.6/GLogue)."""
        if not self.enable_intersect:
            edges = edges[:1]
        # first edge is the primary expansion; the rest are WCOJ membership
        # probes — each weighted by its backend's cost parameter
        weighted = 0.0
        first = True
        for e in edges:
            sigma = self.est.expand_sigma(pattern, e,
                                          new_alias if first else None)
            weighted += (self.alpha_expand if first
                         else self.alpha_intersect) * sigma
            first = False
        # Eq.3 + the distributed backends' per-hop communication term:
        # every frontier row is exchanged once per hop (degree resolution /
        # probe routing), so communication scales with F(p_s), not sigma
        op_cost = f_src * max(weighted, 1e-12) + self.alpha_exchange * f_src
        f_new = self.est.pattern_freq(pattern, bound | {new_alias})
        return op_cost, f_new

    # ---------------------------------------------------------------- search
    def _search(self, pattern: Pattern, subset: frozenset[str]) -> _Best:
        if subset in self._plan_map:
            return self._plan_map[subset]
        self.stats["explored"] += 1
        best = _Best(None, float("inf"))
        self._plan_map[subset] = best  # placeholder (patterns are DAG-free)
        f_t = self.est.pattern_freq(pattern, subset)

        # --- Expand candidates: peel one vertex -------------------------
        for v in sorted(subset):
            rest = subset - {v}
            if not rest:
                continue
            rsub = pattern.induced(rest)
            if not rsub.is_connected():
                continue
            edges = [e for e in pattern.adjacent(v) if e.other(v) in rest]
            if not edges:
                continue
            f_s = self.est.pattern_freq(pattern, rest)
            # LowerBound pruning (lines 10-12): any plan materializing ``rest``
            # pays at least F(p_s); compare against the greedy bound cost*.
            if f_s >= self._bound:
                self.stats["pruned"] += 1
                continue
            child = self._search(pattern, rest)
            if child.plan is None:
                continue
            op_cost, _ = self._expand_cost(pattern, rest, f_s, v, edges)
            cost = child.cost + f_t + op_cost
            if cost < best.cost:
                best.plan = ExpandNode(child.plan, v, edges,
                                       est_frequency=f_t, est_cost=cost)
                best.cost = cost
                self._bound = min(self._bound, cost) if subset == frozenset(
                    pattern.vertices) else self._bound

        # --- Join candidates: split into two overlapping connected parts --
        if self.enable_join and len(subset) >= 3:
            for s1, s2 in self._join_splits(pattern, subset):
                f1 = self.est.pattern_freq(pattern, s1)
                f2 = self.est.pattern_freq(pattern, s2)
                if min(f1, f2) >= self._bound:
                    self.stats["pruned"] += 1
                    continue
                c1 = self._search(pattern, s1)
                c2 = self._search(pattern, s2)
                if c1.plan is None or c2.plan is None:
                    continue
                # both join sides' key columns are gather-exchanged on a
                # distributed backend before the merge
                op_cost = (self.alpha_join + self.alpha_exchange) * (f1 + f2)
                cost = c1.cost + c2.cost + f_t + op_cost
                if cost < best.cost:
                    best.plan = JoinNode(c1.plan, c2.plan,
                                         tuple(sorted(s1 & s2)),
                                         est_frequency=f_t, est_cost=cost)
                    best.cost = cost
        return best

    def _join_splits(self, pattern: Pattern, subset: frozenset[str]):
        """Valid PatternJoinRule splits: connected overlapping halves whose
        union covers every edge of the induced pattern."""
        sub = pattern.induced(subset)
        names = sorted(subset)
        seen = set()
        for r in range(2, len(names)):
            for combo in itertools.combinations(names, r):
                s1 = frozenset(combo)
                # s2 must contain all vertices not in s1 plus the overlap;
                # enumerate overlaps implicitly: s2 = complement + boundary.
                comp = subset - s1
                if not comp:
                    continue
                # boundary vertices of s1 touching comp must be shared
                shared = {v for v in s1
                          for e in sub.adjacent(v) if e.other(v) in comp}
                s2 = frozenset(comp | shared)
                if not shared:
                    continue
                key = (s1, s2)
                if key in seen or (s2, s1) in seen:
                    continue
                seen.add(key)
                if len(s2) >= len(subset):
                    continue
                p1, p2 = pattern.induced(s1), pattern.induced(s2)
                if not (p1.is_connected() and p2.is_connected()):
                    continue
                # every edge covered by one side?
                cov = 0
                for e in sub.edges:
                    in1 = e.src in s1 and e.dst in s1
                    in2 = e.src in s2 and e.dst in s2
                    if in1 or in2:
                        cov += 1
                if cov == len(sub.edges):
                    yield s1, s2


def annotate_estimates(node: PlanNode, pattern: Pattern, est: CardEstimator,
                       cost: CostParams | None = None) -> PlanNode:
    """Fill in ``est_frequency``/``est_cost`` (Eq. 2/3) on plan nodes that
    were built outside Algorithm 2 — the left-deep fallback for
    disconnected patterns and ablation plans carry zeros otherwise, which
    leaves EXPLAIN without per-operator numbers.  Nodes that already carry
    a nonzero frequency (CBO output) are left untouched.  Mutates and
    returns ``node``."""
    cost = cost or CostParams()

    def expand_op_cost(src_freq: float, edges, new_alias: str) -> float:
        weighted = 0.0
        first = True
        for e in edges:
            sigma = est.expand_sigma(pattern, e, new_alias if first else None)
            weighted += (cost.alpha_expand if first
                         else cost.alpha_intersect) * sigma
            first = False
        return (src_freq * max(weighted, 1e-12)
                + cost.alpha_exchange * src_freq)

    def rec(n: PlanNode) -> float:
        if isinstance(n, ScanNode):
            if n.est_frequency == 0.0:
                f = est.vertex_freq(pattern, n.alias)
                n.est_frequency = f
                n.est_cost = cost.alpha_scan * f
            return n.est_cost
        if isinstance(n, ExpandNode):
            child_cost = rec(n.child)
            if n.est_frequency == 0.0:
                bound = n.child.bound_aliases()
                f = est.pattern_freq(pattern, bound | {n.new_alias})
                n.est_frequency = f
                n.est_cost = (child_cost + f + expand_op_cost(
                    n.child.est_frequency, n.edges, n.new_alias))
            return n.est_cost
        if isinstance(n, JoinNode):
            lc, rc = rec(n.left), rec(n.right)
            if n.est_frequency == 0.0:
                s1 = n.left.bound_aliases()
                s2 = n.right.bound_aliases()
                f = est.join_freq(pattern, s1, s2)
                n.est_frequency = f
                n.est_cost = (lc + rc + f
                              + (cost.alpha_join + cost.alpha_exchange)
                              * (n.left.est_frequency
                                 + n.right.est_frequency))
            return n.est_cost
        if isinstance(n, ExpandChainNode):
            child_cost = rec(n.child)
            bound = set(n.child.bound_aliases())
            src_freq = n.child.est_frequency
            acc = child_cost
            for s in n.steps:
                bound.add(s.alias)
                if s.est_frequency == 0.0:
                    f = est.pattern_freq(pattern, frozenset(bound))
                    s.est_frequency = f
                    s.est_cost = acc + f + expand_op_cost(
                        src_freq, [s.edge], s.alias)
                src_freq = s.est_frequency
                acc = s.est_cost
            if n.est_frequency == 0.0 and n.steps:
                n.est_frequency = n.steps[-1].est_frequency
                n.est_cost = n.steps[-1].est_cost
            return n.est_cost
        raise TypeError(n)

    rec(node)
    return node


# ---------------------------------------------------------------- baselines

def random_plan(pattern: Pattern, rng: random.Random,
                est: CardEstimator | None = None) -> PlanNode:
    """A random valid left-deep expansion order (the paper's red-circle
    comparison plans)."""
    aliases = list(pattern.vertices)
    start = rng.choice(aliases)
    node: PlanNode = ScanNode(start)
    bound = {start}
    while len(bound) < len(aliases):
        frontier = sorted({e.other(b) for b in bound
                           for e in pattern.adjacent(b)
                           if e.other(b) not in bound})
        v = rng.choice(frontier)
        edges = [e for e in pattern.adjacent(v) if e.other(v) in bound]
        node = ExpandNode(node, v, edges)
        bound.add(v)
    return node


def low_order_plan(pattern: Pattern, est: CardEstimator,
                   spec: str | PhysicalSpec | None = None) -> PlanNode:
    """Neo4j-style foil: greedy order from low-order stats under the edge
    independence assumption, no GLogue, no WCOJ intersect (single-edge
    expansion; extra cycle edges become post-filters, modeled here by
    expanding on the first edge only). ``spec`` supplies backend cost
    parameters, like the full optimizer."""
    opt = GraphOptimizer(est, enable_join=False, enable_intersect=False,
                         spec=spec)
    return opt.greedy_initial(pattern)


def all_left_deep_plans(pattern: Pattern, limit: int = 10000):
    """Enumerate every left-deep expansion order (for exhaustive tests)."""
    aliases = sorted(pattern.vertices)
    plans = []

    def rec(node, bound):
        if len(plans) >= limit:
            return
        if len(bound) == len(aliases):
            plans.append(node)
            return
        for v in aliases:
            if v in bound:
                continue
            edges = [e for e in pattern.adjacent(v) if e.other(v) in bound]
            if not edges:
                continue
            rec(ExpandNode(node, v, edges), bound | {v})

    for s in aliases:
        rec(ScanNode(s), {s})
    return plans
