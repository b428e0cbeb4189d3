"""Type inference and validation (paper §4.3, Algorithm 1).

Iteratively refines the type constraints of every pattern vertex/edge against
the graph schema until a fixpoint, or returns INVALID when some element admits
no type. Edge constraints are kept as schema *triples*, so direction-sensitive
refinement (paper lines 13-22) is a set intersection.
"""
from __future__ import annotations

import heapq
import itertools

from repro_torch.core.pattern import BOTH, IN, OUT, Pattern
from repro_torch.core.schema import GraphSchema

INVALID = "INVALID"


def _edge_triples_consistent(edge, src_types, dst_types):
    """Triples of ``edge`` consistent with current endpoint constraints,
    honouring direction (BOTH admits either orientation)."""
    keep = set()
    for t in edge.triples:
        fwd = t.src in src_types and t.dst in dst_types
        rev = t.src in dst_types and t.dst in src_types
        if edge.direction == OUT and fwd:
            keep.add(t)
        elif edge.direction == IN and rev:
            keep.add(t)
        elif edge.direction == BOTH and (fwd or rev):
            keep.add(t)
    return frozenset(keep)


def _endpoint_candidates(edge, v_alias, vertices):
    """Vertex types ``v_alias`` may take per edge triples, orientation-aware:
    a triple only contributes a candidate for the orientation whose *other*
    endpoint type is currently feasible (found by a hypothesis property
    test: BOTH edges must not leak the wrong-orientation endpoint type)."""
    src_types = vertices[edge.src].types
    dst_types = vertices[edge.dst].types
    cand = set()
    for t in edge.triples:
        if edge.direction in (OUT, BOTH):      # forward: src->dst
            if v_alias == edge.dst and t.src in src_types:
                cand.add(t.dst)
            if v_alias == edge.src and t.dst in dst_types:
                cand.add(t.src)
        if edge.direction in (IN, BOTH):       # reverse: dst->src
            if v_alias == edge.src and t.src in dst_types:
                cand.add(t.dst)
            if v_alias == edge.dst and t.dst in src_types:
                cand.add(t.src)
    return frozenset(cand)


def infer_types(pattern: Pattern, schema: GraphSchema):
    """Algorithm 1. Returns a *new* Pattern with validated constraints, or the
    string INVALID. The input pattern is not mutated."""
    p = pattern.copy()

    # Drop vertex types with no support in the schema at all.
    for v in p.vertices.values():
        v.types = v.types & schema.all_vertex_types()
        if not v.types:
            return INVALID

    # Line 1: priority queue of vertices, ascending |tau(v)|.
    counter = itertools.count()
    q: list = []
    in_q: set[str] = set()

    def push(alias):
        if alias not in in_q:
            heapq.heappush(q, (len(p.vertices[alias].types), next(counter), alias))
            in_q.add(alias)

    for a in p.vertices:
        push(a)

    while q:                                            # line 2
        _, _, u = heapq.heappop(q)                      # line 3
        in_q.discard(u)
        uv = p.vertices[u]

        # (1) Type refinement for u itself (lines 5-12): a basic type of u is
        # viable only if, for every adjacent pattern edge, the schema offers a
        # triple in that edge's constraint set touching u with the right
        # orientation.
        viable = set()
        for tb in uv.types:
            ok = True
            for e in p.adjacent(u):
                u_is_src = e.src == u
                found = False
                for t in e.triples:
                    if e.direction == OUT:
                        found |= (t.src == tb) if u_is_src else (t.dst == tb)
                    elif e.direction == IN:
                        found |= (t.dst == tb) if u_is_src else (t.src == tb)
                    else:
                        found |= t.src == tb or t.dst == tb
                    if found:
                        break
                if not found:
                    ok = False
                    break
            if ok:
                viable.add(tb)
        if not viable:
            return INVALID
        if viable != uv.types:
            uv.types = frozenset(viable)

        # (2) Refinement for adjacencies (lines 13-22).
        for e in p.adjacent(u):
            v_alias = e.other(u)
            vv = p.vertices[v_alias]
            new_triples = _edge_triples_consistent(
                e, p.vertices[e.src].types, p.vertices[e.dst].types)
            if not new_triples:                          # line 16-18
                return INVALID
            e.triples = new_triples
            cand_v = _endpoint_candidates(e, v_alias, p.vertices)
            new_types = vv.types & cand_v
            if not new_types:
                return INVALID
            if new_types != vv.types:                    # lines 19-21
                vv.types = new_types
                push(v_alias)
            # u itself may also have shrunk via the edge; requeue if so.
            cand_u = _endpoint_candidates(e, u, p.vertices)
            new_u = uv.types & cand_u
            if not new_u:
                return INVALID
            if new_u != uv.types:
                uv.types = new_u
                push(u)
    return p


def enumerate_basic_assignments(pattern: Pattern, schema: GraphSchema,
                                limit: int | None = None):
    """The naive unfold of §4.3 (for testing & GLogue): all BasicType
    assignments of ``pattern`` consistent with the schema. Exponential — only
    used on small patterns and as the oracle for property tests."""
    names = sorted(pattern.vertices)
    domains = [sorted(pattern.vertices[a].types) for a in names]
    out = []
    for combo in itertools.product(*domains):
        assign = dict(zip(names, combo))
        ok = True
        for e in pattern.edges:
            s, d = assign[e.src], assign[e.dst]
            match = False
            for t in e.triples:
                if e.direction == OUT:
                    match |= t.src == s and t.dst == d
                elif e.direction == IN:
                    match |= t.src == d and t.dst == s
                else:
                    match |= (t.src == s and t.dst == d) or (
                        t.src == d and t.dst == s)
                if match:
                    break
            if not match:
                ok = False
                break
        if ok:
            out.append(assign)
            if limit is not None and len(out) >= limit:
                break
    return out
