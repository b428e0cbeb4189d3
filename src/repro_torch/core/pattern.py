"""Pattern graphs (paper §2.1): small connected graphs with type constraints.

``Pattern`` is the PATTERN structure built from a MATCH_PATTERN (§4.2); it is
what type inference (Algorithm 1) and the CBO (Algorithm 2) operate on.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

from repro_torch.core.schema import EdgeTriple, GraphSchema

OUT, IN, BOTH = "OUT", "IN", "BOTH"


@dataclasses.dataclass
class PatternVertex:
    alias: str
    types: frozenset[str]                 # vertex-type constraint
    predicates: list = dataclasses.field(default_factory=list)

    def is_basic(self) -> bool:
        return len(self.types) == 1


@dataclasses.dataclass
class PatternEdge:
    alias: str
    src: str                              # pattern-vertex alias
    dst: str
    triples: frozenset[EdgeTriple]        # edge-type constraint (as triples)
    direction: str = OUT                  # OUT: src->dst, IN: dst->src, BOTH
    hops: int = 1                         # >1 == EXPAND_PATH sugar
    predicates: list = dataclasses.field(default_factory=list)

    def labels(self) -> frozenset[str]:
        return frozenset(t.label for t in self.triples)

    def other(self, v: str) -> str:
        return self.dst if v == self.src else self.src


@dataclasses.dataclass
class Pattern:
    """A connected pattern graph; vertices keyed by alias."""

    vertices: dict[str, PatternVertex] = dataclasses.field(default_factory=dict)
    edges: list[PatternEdge] = dataclasses.field(default_factory=list)

    # -- construction ------------------------------------------------------
    def add_vertex(self, alias: str, types: frozenset[str]) -> PatternVertex:
        if alias in self.vertices:
            # Same alias re-used in MATCH: intersect constraints.
            v = self.vertices[alias]
            v.types = v.types & types if v.types else types
            return v
        v = PatternVertex(alias, types)
        self.vertices[alias] = v
        return v

    def add_edge(self, edge: PatternEdge) -> PatternEdge:
        self.edges.append(edge)
        return edge

    # -- queries -------------------------------------------------------------
    def adjacent(self, alias: str) -> list[PatternEdge]:
        return [e for e in self.edges if alias in (e.src, e.dst)]

    def neighbors(self, alias: str) -> list[str]:
        return [e.other(alias) for e in self.adjacent(alias)]

    def degree(self, alias: str) -> int:
        return len(self.adjacent(alias))

    def n_vertices(self) -> int:
        return len(self.vertices)

    def n_edges(self) -> int:
        return len(self.edges)

    def is_basic(self) -> bool:
        """BasicPattern: every vertex and edge carries a single type (§2.1)."""
        return all(v.is_basic() for v in self.vertices.values()) and all(
            len(e.triples) == 1 for e in self.edges)

    def is_connected(self) -> bool:
        if not self.vertices:
            return False
        seen: set[str] = set()
        stack = [next(iter(self.vertices))]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            stack.extend(self.neighbors(v))
        return seen == set(self.vertices)

    def copy(self) -> "Pattern":
        p = Pattern()
        for a, v in self.vertices.items():
            p.vertices[a] = PatternVertex(a, v.types, list(v.predicates))
        for e in self.edges:
            p.edges.append(PatternEdge(e.alias, e.src, e.dst, e.triples,
                                       e.direction, e.hops, list(e.predicates)))
        return p

    def induced(self, aliases: Iterable[str]) -> "Pattern":
        """Induced sub-pattern on the given vertex aliases."""
        keep = set(aliases)
        p = Pattern()
        for a in keep:
            v = self.vertices[a]
            p.vertices[a] = PatternVertex(a, v.types, list(v.predicates))
        for e in self.edges:
            if e.src in keep and e.dst in keep:
                p.edges.append(PatternEdge(e.alias, e.src, e.dst, e.triples,
                                           e.direction, e.hops,
                                           list(e.predicates)))
        return p

    # -- canonical keys for PlanMap / GLogue --------------------------------
    def vertex_key(self) -> frozenset[str]:
        return frozenset(self.vertices)

    def canonical_key(self):
        """A hashable structural key: sorted (alias,type)+edges. Aliases make
        this exact for sub-patterns of one query pattern (the CBO use case)."""
        vs = tuple(sorted((a, tuple(sorted(v.types)))
                          for a, v in self.vertices.items()))
        es = tuple(sorted((e.src, e.dst, e.direction,
                           tuple(sorted(map(repr, e.triples)))) for e in self.edges))
        return (vs, es)

    def connected_induced_subsets(self) -> list[frozenset[str]]:
        """All vertex subsets whose induced sub-pattern is connected."""
        names = sorted(self.vertices)
        out = []
        for r in range(1, len(names) + 1):
            for combo in itertools.combinations(names, r):
                if self.induced(combo).is_connected():
                    out.append(frozenset(combo))
        return out

    def __repr__(self) -> str:
        vs = ",".join(f"({a}:{'|'.join(sorted(v.types))})"
                      for a, v in sorted(self.vertices.items()))
        es = ",".join(f"{e.src}-[{'|'.join(sorted(e.labels()))}:{e.direction}]-{e.dst}"
                      for e in self.edges)
        return f"Pattern<{vs} ; {es}>"


def expand_path_edges(pattern: Pattern, schema: GraphSchema) -> Pattern:
    """Rewrite hops>1 edges (EXPAND_PATH) into chains of 1-hop edges with
    anonymous intermediate vertices — the composite-op unfolding of §4.1."""
    p = Pattern()
    for a, v in pattern.vertices.items():
        p.vertices[a] = PatternVertex(a, v.types, list(v.predicates))
    anon = 0
    for e in pattern.edges:
        if e.hops <= 1:
            p.edges.append(dataclasses.replace(e, predicates=list(e.predicates)))
            continue
        prev = e.src
        for h in range(e.hops):
            last = h == e.hops - 1
            nxt = e.dst if last else f"__{e.alias}_h{h}_{anon}"
            if not last:
                p.vertices[nxt] = PatternVertex(nxt, schema.all_vertex_types())
            p.edges.append(PatternEdge(f"{e.alias}#{h}", prev, nxt, e.triples,
                                       e.direction, 1))
            prev = nxt
        anon += 1
    return p
