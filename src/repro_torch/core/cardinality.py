"""Cardinality estimation for arbitrary (Union/All-typed) patterns
(paper §5.3.3, Eqs. 4-6) plus predicate selectivities.

The estimator prefers exact GLogue frequencies for BasicPatterns within the
catalogue size; everything else is derived iteratively by vertex-expansion
ratios (Eq. 5/6) and pattern joins (Eq. 4), exactly the paper's scheme for
UnionPatterns. Predicate selectivities (1/NDV for equality, |set|/NDV for IN)
scale vertex frequencies — this is what makes the money-mule case study's
join-vertex position data-dependent.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ir
from repro_torch.core.glogue import GLogue
from repro_torch.core.pattern import BOTH, IN, OUT, Pattern, PatternEdge
from repro_torch.graphdb.storage import GraphStore


class Statistics:
    """Low-order statistics + NDV cache over a store."""

    def __init__(self, store: GraphStore):
        self.store = store
        self._ndv: dict = {}

    def vertex_type_freq(self, vtype: str) -> float:
        return float(self.store.v_count[vtype])

    def triple_freq(self, triple) -> float:
        f = float(self.store.out_csr[triple].nnz)
        # delta-overlay occupancy (MutableGraphStore): net inserted-minus-
        # tombstoned edges count toward the live frequency, so cached plans
        # re-cost against real occupancy after a stats-epoch bump
        counts = getattr(self.store, "delta_edge_counts", None)
        if counts is not None:
            f += float(counts().get(triple, 0))
        return max(f, 0.0)

    def ndv(self, vtype: str, prop: str) -> float:
        key = (vtype, prop)
        if key not in self._ndv:
            col = self.store.v_props.get(vtype, {}).get(prop)
            self._ndv[key] = (float(len(np.unique(col)))
                              if col is not None and col.size else 1.0)
        return self._ndv[key]


def predicate_selectivity(stats: Statistics, types: frozenset[str],
                          preds: list, params: dict | None = None) -> float:
    """Independence-combined selectivity of a vertex's fused predicates.

    ``params`` supplies build-time bindings for late-bound ``ir.Param``
    nodes (prepared-query "value peeking"): an ``IN $S`` predicate is
    |S|/NDV when the set is bound, else an agnostic 0.5.  Equality against a
    ``Param`` is 1/NDV either way — value-independent, so the cached plan
    stays valid across bindings."""
    sel = 1.0
    for p in preds:
        if isinstance(p, ir.Cmp) and isinstance(p.lhs, ir.Prop):
            ndv = max(max((stats.ndv(t, p.lhs.name) for t in types),
                          default=1.0), 1.0)
            sel *= (1.0 / ndv) if p.op == "=" else (1.0 / 3.0)
        elif isinstance(p, ir.InSet) and isinstance(p.item, ir.Prop):
            values = p.values
            if isinstance(values, ir.Param):
                values = (params or {}).get(values.name)
            if values is None:
                sel *= 0.5
                continue
            ndv = max(max((stats.ndv(t, p.item.name) for t in types),
                          default=1.0), 1.0)
            sel *= min(len(values) / ndv, 1.0)
        else:
            sel *= 0.5
    return sel


class CardEstimator:
    def __init__(self, stats: Statistics, glogue: GLogue | None = None,
                 use_selectivity: bool = True, params: dict | None = None):
        self.stats = stats
        self.glogue = glogue
        self.use_selectivity = use_selectivity
        self.params = dict(params or {})   # build-time bindings for Params
        self._memo: dict = {}

    # ----------------------------------------------------------- primitives
    def vertex_freq(self, pattern: Pattern, alias: str,
                    with_preds: bool = True) -> float:
        v = pattern.vertices[alias]
        f = sum(self.stats.vertex_type_freq(t) for t in v.types)
        if with_preds and self.use_selectivity and v.predicates:
            f *= predicate_selectivity(self.stats, v.types, v.predicates,
                                       self.params)
        return max(f, 1e-9)

    def edge_freq(self, edge: PatternEdge) -> float:
        f = sum(self.stats.triple_freq(t) for t in edge.triples)
        if edge.direction == BOTH:
            f *= 2.0
        return max(f, 1e-9)

    def selectivity(self, pattern: Pattern, alias: str) -> float:
        v = pattern.vertices[alias]
        if not (self.use_selectivity and v.predicates):
            return 1.0
        return predicate_selectivity(self.stats, v.types, v.predicates,
                                     self.params)

    def expand_sigma(self, pattern: Pattern, edge: PatternEdge,
                     new_alias: str | None) -> float:
        """Eq. 5. ``new_alias``: the vertex being introduced by this edge, or
        None when the edge closes a cycle (both endpoints already bound)."""
        f_e = self.edge_freq(edge)
        if new_alias is not None:
            anchor = edge.other(new_alias)
            f_anchor = self.vertex_freq(pattern, anchor, with_preds=False)
            sigma = f_e / f_anchor
            sigma *= self.selectivity(pattern, new_alias)
        else:
            f_src = self.vertex_freq(pattern, edge.src, with_preds=False)
            f_dst = self.vertex_freq(pattern, edge.dst, with_preds=False)
            sigma = f_e / (f_src * f_dst)
        return sigma

    # --------------------------------------------------------- pattern freq
    def pattern_freq(self, pattern: Pattern,
                     aliases: frozenset[str] | None = None) -> float:
        """Frequency estimate of (the induced sub-pattern on) ``aliases``.
        Exact via GLogue for catalogued BasicPatterns without predicates;
        otherwise iterative Eq. 6 from a canonical greedy order (paper:
        'Eq. 4 and Eq. 6 can be applied iteratively ... until the source
        pattern is a BasicPattern that can be queried from GLogue directly,
        or a single vertex or single edge')."""
        sub = pattern if aliases is None else pattern.induced(aliases)
        key = sub.canonical_key()
        if key in self._memo:
            return self._memo[key]
        f = self._freq_impl(sub)
        self._memo[key] = f
        return f

    def _glogue_lookup(self, sub: Pattern) -> float | None:
        if self.glogue is None or sub.n_vertices() > self.glogue.k:
            return None
        if any(e.hops > 1 for e in sub.edges):
            return None
        stripped = sub.copy()
        for v in stripped.vertices.values():
            v.predicates = []
        f = self.glogue.get_freq(stripped)
        if f is None:
            return None
        # fold predicate selectivities back in
        for a, v in sub.vertices.items():
            f *= self.selectivity(sub, a)
        return max(f, 1e-9)

    def _freq_impl(self, sub: Pattern) -> float:
        n = sub.n_vertices()
        if n == 1:
            return self.vertex_freq(sub, next(iter(sub.vertices)))
        if n == 2 and sub.n_edges() == 1:
            e = sub.edges[0]
            f = self.edge_freq(e)
            f *= self.selectivity(sub, e.src) * self.selectivity(sub, e.dst)
            return max(f, 1e-9)
        exact = self._glogue_lookup(sub)
        if exact is not None:
            return exact
        # iterative Eq. 6: peel the last vertex in a canonical greedy order
        # (min-degree-last keeps the source connected).
        order = sorted(sub.vertices)
        # choose a leaf-ish vertex to peel whose removal keeps connectivity
        for cand in sorted(order, key=lambda a: sub.degree(a)):
            rest = frozenset(set(order) - {cand})
            if not rest:
                continue
            rsub = sub.induced(rest)
            if rsub.is_connected():
                edges = [e for e in sub.edges if cand in (e.src, e.dst)]
                f_src = self.pattern_freq(sub, rest)
                sigma = 1.0
                first = True
                for e in edges:
                    sigma *= self.expand_sigma(sub, e,
                                               cand if first else None)
                    first = False
                f = f_src * sigma
                # cache union estimates into GLogue (Alg. 2 lines 15-17)
                if self.glogue is not None and sub.n_vertices() <= self.glogue.k:
                    stripped = sub.copy()
                    for v in stripped.vertices.values():
                        v.predicates = []
                    if self.glogue.get_freq(stripped) is None:
                        self.glogue.put_freq(stripped, f)
                return max(f, 1e-9)
        raise ValueError("disconnected sub-pattern in cardinality estimation")

    def join_freq(self, pattern: Pattern, s1: frozenset[str],
                  s2: frozenset[str]) -> float:
        """Eq. 4 for a pattern join of induced subgraphs s1, s2."""
        inter = s1 & s2
        f1 = self.pattern_freq(pattern, s1)
        f2 = self.pattern_freq(pattern, s2)
        fi = self.pattern_freq(pattern, inter) if inter else 1.0
        return max(f1 * f2 / max(fi, 1e-9), 1e-9)
