"""GLogue — high-order statistics provider (paper §3, §5.3.2, after [33]).

A hierarchical catalogue of BasicPatterns up to ``k`` vertices with their
exact frequencies in the data graph. Size-1/2 frequencies come straight from
the store; 2-edge paths are computed by vectorized degree dot-products;
triangles (3-cycles) by running the engine on the caller's backend — on the
torch spec for cuda that puts every triangle's WCOJ membership probes
through the ``wcoj_intersect`` kernel. Lookup keys are
alias-permutation-canonicalized so any isomorphic query sub-pattern hits.

Only BasicPatterns are stored (as in the paper); UnionPattern frequencies are
*estimated* on top via Eq. 4/5/6 in ``repro_torch.core.cardinality``, which may
cache computed union frequencies back into GLogue (Algorithm 2 lines 15-17).
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.pattern import BOTH, IN, OUT, Pattern, PatternEdge, PatternVertex
from repro_torch.core.schema import EdgeTriple, GraphSchema
from repro_torch.graphdb.storage import GraphStore


def canonical_key(pattern: Pattern):
    """Isomorphism-canonical key for small patterns: minimum over alias
    permutations of the anonymized structural encoding."""
    names = sorted(pattern.vertices)
    best = None
    for perm in itertools.permutations(range(len(names))):
        relabel = {names[i]: f"x{perm[i]}" for i in range(len(names))}
        vs = tuple(sorted((relabel[a], tuple(sorted(v.types)))
                          for a, v in pattern.vertices.items()))
        es = []
        for e in pattern.edges:
            s, d = relabel[e.src], relabel[e.dst]
            if e.direction == BOTH and s > d:
                s, d = d, s
            dirn = e.direction
            # normalize orientation: store IN edges as OUT of the other side
            if dirn == IN:
                s, d, dirn = d, s, OUT
            es.append((s, d, dirn, tuple(sorted(t.label for t in e.triples)),
                       tuple(sorted(map(repr, e.triples)))))
        key = (vs, tuple(sorted(es)))
        if best is None or key < best:
            best = key
    return best


class GLogue:
    def __init__(self, store: GraphStore, k: int = 3,
                 count_triangles: bool = True, spec=None):
        self.store = store
        # backend the triangle counts execute on (a PhysicalSpec or a
        # registered name; None -> the default "torch" spec, on cuda)
        self.spec = spec if spec is not None else "torch"
        self.schema: GraphSchema = store.schema
        self.k = k
        self.freq: dict = {}          # canonical key -> frequency (float)
        self._build(count_triangles)

    # --------------------------------------------------------------- lookups
    def get_freq(self, pattern: Pattern) -> float | None:
        return self.freq.get(canonical_key(pattern))

    def put_freq(self, pattern: Pattern, f: float) -> None:
        """Cache an estimated (e.g. union) frequency — Alg.2 lines 15-17."""
        self.freq[canonical_key(pattern)] = f

    # ---------------------------------------------------------------- build
    def _build(self, count_triangles: bool):
        st = self.store
        # size 1: vertices
        for t in self.schema.vertex_types:
            p = Pattern()
            p.add_vertex("a", frozenset({t}))
            self.freq[canonical_key(p)] = float(st.v_count[t])
        # size 2: single edges
        for tr, csr in st.out_csr.items():
            p = Pattern()
            p.add_vertex("a", frozenset({tr.src}))
            p.add_vertex("b", frozenset({tr.dst}))
            p.add_edge(PatternEdge("e", "a", "b", frozenset({tr}), OUT))
            self.freq[canonical_key(p)] = float(csr.nnz)
        if self.k < 3:
            return
        # size 3, 2-edge paths: F = sum over shared vertex of deg1*deg2.
        triples = sorted(st.out_csr, key=repr)
        for t1, t2 in itertools.product(triples, triples):
            # shared vertex can be: t1.src==t2.src, t1.src==t2.dst,
            # t1.dst==t2.src, t1.dst==t2.dst
            for side1, side2 in (("src", "src"), ("src", "dst"),
                                 ("dst", "src"), ("dst", "dst")):
                if getattr(t1, side1) != getattr(t2, side2):
                    continue
                p = Pattern()
                shared_t = getattr(t1, side1)
                p.add_vertex("m", frozenset({shared_t}))
                p.add_vertex("a", frozenset(
                    {t1.dst if side1 == "src" else t1.src}))
                p.add_vertex("b", frozenset(
                    {t2.dst if side2 == "src" else t2.src}))
                # edge 1 between m and a
                if side1 == "src":
                    p.add_edge(PatternEdge("e1", "m", "a",
                                           frozenset({t1}), OUT))
                else:
                    p.add_edge(PatternEdge("e1", "a", "m",
                                           frozenset({t1}), OUT))
                if side2 == "src":
                    p.add_edge(PatternEdge("e2", "m", "b",
                                           frozenset({t2}), OUT))
                else:
                    p.add_edge(PatternEdge("e2", "b", "m",
                                           frozenset({t2}), OUT))
                key = canonical_key(p)
                if key in self.freq:
                    continue
                d1 = self._degrees(t1, side1)
                d2 = self._degrees(t2, side2)
                f = float(np.dot(d1.astype(np.float64), d2.astype(np.float64)))
                # same triple both edges from the same vertex would count the
                # (e1==e2) pairing too; homomorphism semantics keeps it.
                self.freq[key] = f
        if count_triangles:
            self._count_triangles(triples)

    def _degrees(self, triple: EdgeTriple, side: str) -> np.ndarray:
        csr = (self.store.out_csr if side == "src" else
               self.store.in_csr)[triple]
        return np.diff(csr.indptr)

    def _count_triangles(self, triples):
        """Exact triangle-pattern frequencies via the engine (size-3 cycles).
        Enumerates type-compatible triple combos; counts via one WCOJ plan."""
        from repro_torch.core.physical import ExpandNode, ScanNode
        from repro_torch.graphdb.engine import Engine, ExecStats

        eng = Engine(self.store, backend=self.spec)
        seen = set()
        for t1, t2, t3 in itertools.product(triples, triples, triples):
            # orientationless triangle over vertex types A,B,C:
            #   e1 connects (a,b), e2 connects (b,c), e3 connects (a,c)
            for o1, o2, o3 in itertools.product((0, 1), repeat=3):
                A, B = (t1.src, t1.dst) if o1 == 0 else (t1.dst, t1.src)
                B2, C = (t2.src, t2.dst) if o2 == 0 else (t2.dst, t2.src)
                A2, C2 = (t3.src, t3.dst) if o3 == 0 else (t3.dst, t3.src)
                if B != B2 or A != A2 or C != C2:
                    continue
                p = Pattern()
                p.add_vertex("a", frozenset({A}))
                p.add_vertex("b", frozenset({B}))
                p.add_vertex("c", frozenset({C}))
                p.add_edge(PatternEdge("e1", "a", "b", frozenset({t1}),
                                       OUT if o1 == 0 else IN))
                p.add_edge(PatternEdge("e2", "b", "c", frozenset({t2}),
                                       OUT if o2 == 0 else IN))
                p.add_edge(PatternEdge("e3", "a", "c", frozenset({t3}),
                                       OUT if o3 == 0 else IN))
                key = canonical_key(p)
                if key in seen:
                    continue
                seen.add(key)
                plan = ExpandNode(
                    ExpandNode(ScanNode("a"), "b",
                               [p.edges[0]]), "c", [p.edges[1], p.edges[2]])
                stats = ExecStats()
                try:
                    tbl = eng.exec_pattern(p, plan, stats)
                    self.freq[key] = float(tbl.nrows)
                except RuntimeError as exc:
                    # only the blow-up cap leaves a triangle to estimation;
                    # a device or kernel failure must surface
                    if "intermediate blow-up" not in str(exc):
                        raise
