"""Gremlin-style traversal frontend (paper §4.2's second frontend).

A thin sugar layer over ``GraphIrBuilder`` (DESIGN.md §3) — every step
delegates to the unified builder, demonstrating the IR's language
independence: the Cypher parser and this traversal produce canonically
identical GIR for equivalent queries.

    g(schema).V().as_("v1").out().as_("v2").out("LOCATEDIN", "PRODUCEDIN") \
        .as_("v3", types=["PLACE"]) \
        .where(Cmp("=", Prop("v3", "name"), Lit("China"))) \
        .group_count("v1")

Classic terminal steps (``count`` / ``group_count`` / ``values``) return the
``LogicalPlan`` directly.  For relational tails (ORDER BY / LIMIT), chain
``group_by`` / ``project`` / ``order_by`` / ``limit`` and finish with
``plan()``.  Late-bound parameters come from ``.param(name)``.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.ir_builder import GraphIrBuilder
from repro_torch.core.pattern import BOTH, IN, OUT
from repro_torch.core.schema import GraphSchema


class GremlinTraversal:
    def __init__(self, schema: GraphSchema, params: dict | None = None):
        self.b = GraphIrBuilder(schema, params)

    # -- pattern steps ------------------------------------------------------
    def V(self, *types: str) -> "GremlinTraversal":
        self.b.scan(None, list(types) or None)
        return self

    def _expand(self, labels, direction):
        # materialize target immediately with an anonymous alias; `as_`
        # renames (alias management lives in the builder)
        self.b.expand(list(labels) or None, direction=direction)
        self.b.get_vertex()
        return self

    def out(self, *labels):
        return self._expand(labels, OUT)

    def in_(self, *labels):
        return self._expand(labels, IN)

    def both(self, *labels):
        return self._expand(labels, BOTH)

    def out_path(self, hops, *labels, direction: str = OUT):
        """Multi-hop expansion (EXPAND_PATH); ``hops`` may be a structural
        parameter name bound via the traversal's ``params``."""
        self.b.expand_path(list(labels) or None, hops=hops,
                           direction=direction)
        self.b.get_vertex()
        return self

    def as_(self, name: str, types=None) -> "GremlinTraversal":
        """Rename the current anonymous vertex; optionally constrain types."""
        self.b.alias_as(name, types)
        return self

    def select(self, name: str) -> "GremlinTraversal":
        self.b.at(name)
        return self

    def where(self, pred) -> "GremlinTraversal":
        self.b.where(pred)
        return self

    def has(self, prop: str, value) -> "GremlinTraversal":
        val = value if isinstance(value, (ir.Param, ir.Lit)) else ir.Lit(value)
        self.b.where(ir.Cmp("=", ir.Prop(self.b.current, prop), val))
        return self

    def param(self, name: str) -> ir.Param:
        return self.b.param(name)

    # -- chainable relational steps (finish with .plan()) -------------------
    def project(self, items, distinct: bool = False) -> "GremlinTraversal":
        self.b.project(items, distinct=distinct)
        return self

    def group_by(self, keys, aggs) -> "GremlinTraversal":
        self.b.group(keys, aggs)
        return self

    def order_by(self, *items, limit: int | None = None) -> "GremlinTraversal":
        self.b.order(list(items), limit=limit)
        return self

    def limit(self, n: int) -> "GremlinTraversal":
        self.b.limit(n)
        return self

    def plan(self) -> ir.LogicalPlan:
        return self.b.build()

    # -- classic terminal steps --------------------------------------------
    def count(self, alias: str | None = None,
              as_: str = "count") -> ir.LogicalPlan:
        arg = ir.Var(alias or self.b.current)
        return self.b.group([], [(ir.Agg("COUNT", arg), as_)]).build()

    def group_count(self, alias: str, as_: str = "count") -> ir.LogicalPlan:
        return self.b.group([(ir.Var(alias), alias)],
                            [(ir.Agg("COUNT", None), as_)]).build()

    def values(self, *items) -> ir.LogicalPlan:
        return self.b.project(list(items)).build()


def g(schema: GraphSchema, params: dict | None = None) -> GremlinTraversal:
    return GremlinTraversal(schema, params)
