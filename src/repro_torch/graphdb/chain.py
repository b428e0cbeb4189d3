"""Chain specs — the engine<->backend contract for fused ``ExpandChainNode``
execution (DESIGN.md §8).

The engine compiles a chain node against its pattern + store into a
``ChainSpec``: per hop, the CSR orientations the expansion concatenates (in
the exact order of the per-hop loop), the trailing WCOJ membership probes of
an expand-and-intersect tail, and the hop predicates in chain-fusable form
(static signature + runtime slots, ``core.physical.compile_chain_predicate``).
A backend that advertises fused-chain support (``OperatorSet.chain_program``)
turns the spec into one compiled program — a single device dispatch for the
whole chain.  ``build_chain_spec`` returns ``None`` whenever any hop falls
outside the fusable envelope (mixed-type aliases, multi-orientation probes,
uncompilable predicates); the engine then runs its per-hop loop, which stays
the semantics oracle either way.

``ChainSpec.signature()`` is purely structural (no CSR identity): one
compiled program serves every chain with the same shape against the same
store, and parameter/literal values ride in runtime slots so rebinding a
parameter never recompiles.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import ir
from repro_torch.core.pattern import BOTH, IN, OUT, PatternEdge
from repro_torch.core.physical import ExpandChainNode, compile_chain_predicate


class ChainFallback(Exception):
    """A runtime condition the fused program cannot honor (non-integer or
    out-of-envelope slot value): the engine falls back to the per-hop loop
    for this execution only."""


def orientations(e: PatternEdge, from_alias: str):
    """Yield (csr_kind, triple) pairs for expanding edge ``e`` from
    ``from_alias`` — csr_kind 'out' keys the CSR by the data-edge source.
    The single source of truth for orientation order: the engine's per-hop
    loop and the fused chain program must concatenate identically."""
    dirs = [OUT, IN] if e.direction == BOTH else [e.direction]
    for d in dirs:
        data_src, data_dst = (e.src, e.dst) if d == OUT else (e.dst, e.src)
        use_out = from_alias == data_src
        for t in sorted(e.triples, key=repr):
            yield ("out" if use_out else "in"), t


@dataclasses.dataclass
class OrientSpec:
    """One CSR the expansion (or probe) reads: local row = global id - lo.
    ``[lo, hi)`` is the keyed type's id range — rows outside it (a
    mixed-type frontier alias) contribute zero degree, exactly like the
    per-hop loop's membership mask."""
    kind: str            # "out" | "in"
    csr: object          # storage.CSR (backend uploads/caches device twins)
    lo: int              # keyed-type range start
    hi: int              # keyed-type range end (exclusive)
    tidx: int            # triple index for the edge's '#t' identity column

    def sig(self) -> tuple:
        return (self.kind, self.lo, self.hi, self.tidx,
                self.csr.pos is not None)


@dataclasses.dataclass
class ProbeSpec:
    """A trailing WCOJ membership probe: is (from_alias, hop alias) an edge
    of ``orient``?  Restricted to a single orientation so the probe is a
    pure filter (a multi-orientation intersect concatenates per-orientation
    parts and can emit a row twice — that stays on the per-hop loop).
    ``[vlo, vhi)`` is the probed value type's id range: rows whose target
    falls outside (mixed-type hop alias) fail the probe, like the loop's
    candidate mask."""
    edge_alias: str
    from_alias: str
    orient: OrientSpec
    vlo: int
    vhi: int

    def sig(self) -> tuple:
        return (self.edge_alias, self.from_alias, self.orient.sig(),
                self.vlo, self.vhi)


@dataclasses.dataclass
class HopSpec:
    from_alias: str
    alias: str
    edge_alias: str
    orients: list[OrientSpec]
    probes: list[ProbeSpec]
    pred_sig: tuple | None     # combined hop predicate (over global slots)

    def sig(self) -> tuple:
        return (self.from_alias, self.alias, self.edge_alias,
                tuple(o.sig() for o in self.orients),
                tuple(p.sig() for p in self.probes), self.pred_sig)


@dataclasses.dataclass
class ChainSpec:
    source: str
    hops: list[HopSpec]
    # runtime slot descriptors, ("scalar", lhs, rhs) | ("values", item, vals);
    # indices in pred_sig refer into this list — the engine evaluates them
    # per execution (encoding, parameter resolution)
    slots: list

    def signature(self) -> tuple:
        return (self.source, tuple(h.sig() for h in self.hops), len(self.slots))

    @property
    def has_params(self) -> bool:
        # s[2] is the slot's value side: the Cmp rhs or the InSet values
        # (a whole-list ``$S`` rides as a single Param node)
        return any(isinstance(s[2], ir.Param) for s in self.slots)


def build_chain_spec(store, tindex, pattern, node: ExpandChainNode
                     ) -> ChainSpec | None:
    """Compile ``node`` into a ``ChainSpec``, or ``None`` when any hop is
    outside the fusable envelope (the per-hop loop then executes it)."""
    first = node.steps[0].from_alias
    vertex_aliases = {first} | {s.alias for s in node.steps}
    edge_aliases = {e.alias for s in node.steps for e in s.all_edges()}
    slots: list = []
    hops: list[HopSpec] = []
    for s in node.steps:
        src_types = pattern.vertices[s.from_alias].types
        new_types = pattern.vertices[s.alias].types
        if s.from_alias not in vertex_aliases:
            return None
        orients = []
        for kind, t in orientations(s.edge, s.from_alias):
            keyed = t.src if kind == "out" else t.dst
            value = t.dst if kind == "out" else t.src
            if value not in new_types or keyed not in src_types:
                continue
            lo, hi = store.type_range(keyed)
            csr = (store.out_csr if kind == "out" else store.in_csr)[t]
            orients.append(OrientSpec(kind, csr, lo, hi, tindex[t]))
        if not orients:
            return None                      # provably-empty hop: loop it
        probes = []
        for e in s.intersect_edges:
            frm = e.other(s.alias)
            cand_types = new_types
            frm_types = pattern.vertices[frm].types
            if frm not in vertex_aliases:
                return None
            po = []
            for kind, t in orientations(e, frm):
                keyed = t.src if kind == "out" else t.dst
                value = t.dst if kind == "out" else t.src
                if keyed not in frm_types or value not in cand_types:
                    continue
                lo, hi = store.type_range(keyed)
                vlo, vhi = store.type_range(value)
                csr = (store.out_csr if kind == "out" else store.in_csr)[t]
                po.append((OrientSpec(kind, csr, lo, hi, tindex[t]),
                           vlo, vhi))
            if len(po) != 1:                 # pure-filter probes only
                return None
            probes.append(ProbeSpec(e.alias, frm, po[0][0],
                                    po[0][1], po[0][2]))
        # hop predicates, in the per-hop loop's application order: vertex
        # predicates, then each edge's predicates
        preds = list(pattern.vertices[s.alias].predicates or [])
        for e in s.all_edges():
            preds.extend(e.predicates or [])
        parts = tuple(compile_chain_predicate(p, vertex_aliases, edge_aliases,
                                              slots)
                      for p in preds)
        if any(p is None for p in parts):
            return None
        pred_sig = ("and", parts) if parts else None
        hops.append(HopSpec(s.from_alias, s.alias, s.edge.alias,
                            orients, probes, pred_sig))
    return ChainSpec(first, hops, slots)
