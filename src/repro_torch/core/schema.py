"""Property-graph schema and type constraints (paper §2.1).

A schema lists vertex types and edge *triples* (src_type, label, dst_type).
Type constraints on pattern elements follow the paper's three kinds:

- BasicType: a single type;
- UnionType: a set of types ("A|B");
- AllType:   every type in the schema.

Internally every constraint is a frozenset of basic names; vertex constraints
hold vertex-type names, edge constraints hold *triples* — the paper models an
edge type as a triplet ``(src_type, label, dst_type)`` (§4.1, Edge datatype),
which is what makes the Algorithm-1 fixpoint precise.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class EdgeTriple:
    src: str
    label: str
    dst: str

    def __repr__(self) -> str:
        return f"{self.src}-[{self.label}]->{self.dst}"


@dataclasses.dataclass(frozen=True)
class GraphSchema:
    """Vertex types, edge triples and their property signatures."""

    vertex_types: tuple[str, ...]
    edge_triples: tuple[EdgeTriple, ...]
    vertex_props: Mapping[str, Mapping[str, str]] = dataclasses.field(
        default_factory=dict)
    edge_props: Mapping[str, Mapping[str, str]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        vt = set(self.vertex_types)
        for t in self.edge_triples:
            if t.src not in vt or t.dst not in vt:
                raise ValueError(f"edge triple {t} references unknown vertex type")

    # -- lookups used by Algorithm 1 -------------------------------------
    def all_vertex_types(self) -> frozenset[str]:
        return frozenset(self.vertex_types)

    def all_edge_triples(self) -> frozenset[EdgeTriple]:
        return frozenset(self.edge_triples)

    def edge_labels(self) -> frozenset[str]:
        return frozenset(t.label for t in self.edge_triples)

    def triples_with_label(self, labels: frozenset[str]) -> frozenset[EdgeTriple]:
        return frozenset(t for t in self.edge_triples if t.label in labels)

    def out_triples(self, vtype: str) -> frozenset[EdgeTriple]:
        return frozenset(t for t in self.edge_triples if t.src == vtype)

    def in_triples(self, vtype: str) -> frozenset[EdgeTriple]:
        return frozenset(t for t in self.edge_triples if t.dst == vtype)

    def vertex_prop_dtype(self, vtype: str, prop: str) -> str | None:
        return self.vertex_props.get(vtype, {}).get(prop)

    # -- constraint constructors ------------------------------------------
    def vertex_constraint(self, spec: Sequence[str] | None) -> frozenset[str]:
        """BasicType (len==1), UnionType (len>1) or AllType (None/empty)."""
        if not spec:
            return self.all_vertex_types()
        unknown = set(spec) - set(self.vertex_types)
        if unknown:
            raise ValueError(f"unknown vertex types {sorted(unknown)}")
        return frozenset(spec)

    def edge_constraint(self, labels: Sequence[str] | None) -> frozenset[EdgeTriple]:
        if not labels:
            return self.all_edge_triples()
        unknown = set(labels) - set(self.edge_labels())
        if unknown:
            raise ValueError(f"unknown edge labels {sorted(unknown)}")
        return self.triples_with_label(frozenset(labels))


def ldbc_schema() -> GraphSchema:
    """The LDBC SNB schema subset used throughout the paper's experiments."""
    E = EdgeTriple
    return GraphSchema(
        vertex_types=(
            "PERSON", "POST", "COMMENT", "FORUM", "TAG", "TAGCLASS",
            "CITY", "COUNTRY", "ORGANISATION",
        ),
        edge_triples=(
            E("PERSON", "KNOWS", "PERSON"),
            E("PERSON", "LIKES", "POST"),
            E("PERSON", "LIKES", "COMMENT"),
            E("PERSON", "HASINTEREST", "TAG"),
            E("PERSON", "ISLOCATEDIN", "CITY"),
            E("PERSON", "WORKAT", "ORGANISATION"),
            E("POST", "HASCREATOR", "PERSON"),
            E("COMMENT", "HASCREATOR", "PERSON"),
            E("COMMENT", "REPLYOF", "POST"),
            E("COMMENT", "REPLYOF", "COMMENT"),
            E("POST", "HASTAG", "TAG"),
            E("COMMENT", "HASTAG", "TAG"),
            E("FORUM", "CONTAINEROF", "POST"),
            E("FORUM", "HASMEMBER", "PERSON"),
            E("FORUM", "HASMODERATOR", "PERSON"),
            E("FORUM", "HASTAG", "TAG"),
            E("TAG", "HASTYPE", "TAGCLASS"),
            E("CITY", "ISPARTOF", "COUNTRY"),
            E("ORGANISATION", "ISLOCATEDIN", "COUNTRY"),
        ),
        vertex_props={
            "PERSON": {"id": "int", "firstName": "str", "creationDate": "int"},
            "POST": {"id": "int", "length": "int", "creationDate": "int"},
            "COMMENT": {"id": "int", "length": "int", "creationDate": "int"},
            "FORUM": {"id": "int", "creationDate": "int"},
            "TAG": {"id": "int", "name": "str"},
            "TAGCLASS": {"id": "int", "name": "str"},
            "CITY": {"id": "int", "name": "str"},
            "COUNTRY": {"id": "int", "name": "str"},
            "ORGANISATION": {"id": "int", "name": "str"},
        },
        edge_props={"KNOWS": {"creationDate": "int"}},
    )


def motivating_schema() -> GraphSchema:
    """Fig. 1(a): Person/Product/Place with Purchases/LocatedIn/ProducedIn/Knows."""
    E = EdgeTriple
    return GraphSchema(
        vertex_types=("PERSON", "PRODUCT", "PLACE"),
        edge_triples=(
            E("PERSON", "KNOWS", "PERSON"),
            E("PERSON", "PURCHASES", "PRODUCT"),
            E("PERSON", "LOCATEDIN", "PLACE"),
            E("PRODUCT", "PRODUCEDIN", "PLACE"),
        ),
        vertex_props={
            "PERSON": {"id": "int", "name": "str"},
            "PRODUCT": {"id": "int", "name": "str"},
            "PLACE": {"id": "int", "name": "str"},
        },
    )
