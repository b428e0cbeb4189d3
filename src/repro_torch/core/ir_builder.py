"""GraphIrBuilder — the unified front-end API (paper §4.1–4.2, DESIGN.md §3).

The *only* sanctioned way to construct GIR ``LogicalPlan`` objects.  Every
query language lowers through this builder: the Cypher parser
(``core/parser.py``) is tokenizer + grammar driving builder steps, and the
Gremlin traversal (``core/gremlin.py``) is a thin sugar layer over it.  The
builder owns the three concerns the frontends used to duplicate:

- **alias management** — fresh anonymous aliases, renames (``alias_as``),
  cycle-closing merges, and MATCH-reuse constraint intersection;
- **schema-constraint lookup** — vertex-type / edge-label constraints are
  resolved here, once;
- **eager per-step validation** — unknown labels, aliases and properties
  raise ``BuildError`` at the offending step with its position in the
  message, instead of surfacing deep in the optimizer or the engine.

Parameters are first-class: ``param(name)`` returns an ``ir.Param`` node
that survives into the physical plan and is bound at execution time.
*Structural* parameters (hop counts, which change the pattern shape) must be
bound at build time via the ``params`` argument; value parameters stay late
bound, and any build-time bindings are kept on the plan as defaults and as
selectivity hints for the CBO.

    b = GraphIrBuilder(schema, params={"hops": 2})
    plan = (b.scan("p", ["PERSON"])
            .expand(["KNOWS"], direction=BOTH, hops="hops")
            .get_vertex("friend", ["PERSON"])
            .select(ir.Cmp("=", ir.Prop("p", "id"), b.param("pid")))
            .group([(ir.Var("friend"), "friend")],
                   [(ir.Agg("COUNT", ir.Var("p")), "c")])
            .order([(ir.Var("c"), False)], limit=20)
            .build())
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.errors import BuildError, ParamError
from repro_torch.core.pattern import BOTH, IN, OUT, Pattern, PatternEdge
from repro_torch.core.schema import GraphSchema

_DIRECTIONS = (OUT, IN, BOTH)


class GraphIrBuilder:
    """Fluent, eagerly-validated construction of unified-IR logical plans."""

    def __init__(self, schema: GraphSchema, params: dict | None = None):
        self.schema = schema
        self.pattern = Pattern()
        self._params = dict(params or {})     # build-time bindings (defaults)
        self._declared: set[str] = set(self._params)
        self._consumed: dict = {}             # structural params used so far
        self._preds: list = []                # WHERE conjuncts (one Select)
        self._rel_ops: list = []              # Project/Group/Order/Limit
        self._out_names: set[str] = set()     # output columns of project/group
        self._cur: str | None = None          # cursor vertex alias
        self._pending: dict | None = None     # expand() awaiting get_vertex()
        self._anon = 0
        self._nsteps = 0
        self._step: tuple[int, str] = (0, "init")

    # ------------------------------------------------------------ utilities
    @property
    def current(self) -> str | None:
        """The cursor: the vertex alias the next ``expand`` starts from."""
        return self._cur

    def _begin(self, name: str) -> None:
        self._nsteps += 1
        self._step = (self._nsteps, name)

    def _err(self, msg: str) -> BuildError:
        return BuildError(msg, step=self._step)

    def _fresh(self, prefix: str) -> str:
        self._anon += 1
        return f"_{prefix}{self._anon}"

    def _vertex_constraint(self, types) -> frozenset[str]:
        try:
            return self.schema.vertex_constraint(
                list(types) if types else None)
        except ValueError as exc:
            raise self._err(f"{exc}; known vertex types: "
                            f"{sorted(self.schema.vertex_types)}") from None

    def _edge_constraint(self, labels) -> frozenset:
        try:
            return self.schema.edge_constraint(
                list(labels) if labels else None)
        except ValueError as exc:
            raise self._err(f"{exc}; known edge labels: "
                            f"{sorted(self.schema.edge_labels())}") from None

    def _edge_aliases(self) -> set[str]:
        return {e.alias for e in self.pattern.edges}

    def _resolve_structural(self, value, what: str) -> int:
        """Hop counts change the pattern shape, so they must be bound now."""
        if isinstance(value, ir.Param):
            value = value.name
        if isinstance(value, str):
            name = value[1:] if value.startswith("$") else value
            self._declared.add(name)
            if name not in self._params:
                raise ParamError(
                    f"structural parameter ${name} ({what}) must be bound at "
                    f"build time", missing=[name], declared=self._declared)
            self._consumed[name] = self._params[name]
            value = self._params[name]
        try:
            return int(value)
        except (TypeError, ValueError):
            raise self._err(f"{what} must be an integer, got {value!r}") \
                from None

    # ------------------------------------------------------------ params
    def param(self, name: str) -> ir.Param:
        """Declare (or re-reference) a late-bound parameter."""
        name = name[1:] if name.startswith("$") else name
        if not name.isidentifier():
            raise self._err(f"invalid parameter name ${name}")
        self._declared.add(name)
        return ir.Param(name)

    def declared_params(self) -> frozenset[str]:
        return frozenset(self._declared)

    def consumed_params(self) -> dict:
        """Structural bindings consumed while building (e.g. hop counts) —
        the part of ``params`` that is baked into the pattern shape."""
        return dict(self._consumed)

    # ------------------------------------------------- expression validation
    def _validate_expr(self, e, allow_outputs: bool = False) -> None:
        known = set(self.pattern.vertices) | self._edge_aliases()
        for a in ir.expr_aliases(e):
            if a in known:
                continue
            if allow_outputs and a in self._out_names:
                continue
            raise self._err(
                f"unknown alias {a!r}; pattern aliases: {sorted(known)}"
                + (f"; output columns: {sorted(self._out_names)}"
                   if allow_outputs and self._out_names else ""))
        for p in ir.expr_props(e):
            self._validate_prop(p)
        self._declared |= ir.expr_params(e)

    def _validate_prop(self, p: ir.Prop) -> None:
        v = self.pattern.vertices.get(p.alias)
        if v is not None:
            if any(p.name in self.schema.vertex_props.get(t, {})
                   for t in v.types):
                return
            raise self._err(
                f"no vertex type of {p.alias!r} "
                f"({'|'.join(sorted(v.types))}) has property {p.name!r}")
        edge = next((e for e in self.pattern.edges if e.alias == p.alias),
                    None)
        if edge is not None:
            if any(p.name in self.schema.edge_props.get(t.label, {})
                   for t in edge.triples):
                return
            raise self._err(
                f"no edge label of {p.alias!r} "
                f"({'|'.join(sorted(edge.labels()))}) has property "
                f"{p.name!r}")
        # alias unknown — reported by the alias check with a better message
        raise self._err(f"unknown alias {p.alias!r} in property access "
                        f"{p.alias}.{p.name}")

    def _require_open_pattern(self, what: str) -> None:
        if self._rel_ops:
            raise self._err(f"{what} must precede relational steps")
        if self._pending is not None:
            raise self._err(f"{what} while an expand() awaits get_vertex()")

    # ---------------------------------------------------------- graph steps
    def scan(self, alias: str | None = None, types=None) -> "GraphIrBuilder":
        """Bind a (new or existing) pattern vertex and move the cursor there.
        Re-scanning an existing alias intersects its type constraint
        (MATCH-reuse semantics)."""
        self._begin("scan")
        self._require_open_pattern("scan")
        constraint = self._vertex_constraint(types)
        alias = alias or self._fresh("v")
        if alias in self._edge_aliases():
            raise self._err(f"alias {alias!r} already names an edge")
        self.pattern.add_vertex(alias, constraint)
        self._cur = alias
        return self

    def expand(self, labels=None, direction: str = OUT,
               alias: str | None = None, hops=1) -> "GraphIrBuilder":
        """Start an edge from the cursor; ``get_vertex`` binds the target.
        ``hops`` may be an int, a parameter name, or an ``ir.Param`` —
        parameters here are structural and resolved immediately."""
        self._begin("expand")
        self._require_open_pattern("expand")
        if self._cur is None:
            raise self._err("expand() before any scan()")
        if direction not in _DIRECTIONS:
            raise self._err(f"direction must be one of {_DIRECTIONS}, "
                            f"got {direction!r}")
        triples = self._edge_constraint(labels)
        hops = self._resolve_structural(hops, "hop count")
        if hops < 1:
            raise self._err(f"hop count must be >= 1, got {hops}")
        if alias is not None and (alias in self._edge_aliases()
                                  or alias in self.pattern.vertices):
            raise self._err(f"edge alias {alias!r} already in use")
        self._pending = {"alias": alias or self._fresh("e"), "src": self._cur,
                         "triples": triples, "direction": direction,
                         "hops": hops}
        return self

    def expand_path(self, labels=None, hops=2, direction: str = OUT,
                    alias: str | None = None) -> "GraphIrBuilder":
        """EXPAND_PATH sugar: a multi-hop edge (unfolded by the optimizer)."""
        return self.expand(labels, direction=direction, alias=alias,
                           hops=hops)

    def get_vertex(self, alias: str | None = None,
                   types=None) -> "GraphIrBuilder":
        """Bind the target of the pending ``expand``.  An existing alias
        closes a cycle (constraints intersect); a new/omitted alias creates
        the vertex."""
        self._begin("get_vertex")
        if self._pending is None:
            raise self._err("get_vertex() without a preceding expand()")
        pend, self._pending = self._pending, None
        constraint = self._vertex_constraint(types)
        alias = alias or self._fresh("v")
        if alias in self._edge_aliases():
            raise self._err(f"alias {alias!r} already names an edge")
        self.pattern.add_vertex(alias, constraint)
        self.pattern.add_edge(PatternEdge(
            pend["alias"], pend["src"], alias, pend["triples"],
            pend["direction"], pend["hops"]))
        self._cur = alias
        return self

    def alias_as(self, name: str, types=None) -> "GraphIrBuilder":
        """Rename the cursor vertex (Gremlin ``as_``).  Renaming onto an
        existing alias merges the two vertices (closing a cycle)."""
        self._begin("alias_as")
        self._require_open_pattern("alias_as")
        old = self._cur
        if old is None:
            raise self._err("alias_as() before any vertex step")
        if name in self._edge_aliases():
            raise self._err(f"alias {name!r} already names an edge")
        if name != old:
            if name in self.pattern.vertices:
                tgt = self.pattern.vertices[name]
                ov = self.pattern.vertices.pop(old)
                tgt.types = tgt.types & ov.types
                tgt.predicates.extend(ov.predicates)
            else:
                v = self.pattern.vertices.pop(old)
                v.alias = name
                self.pattern.vertices[name] = v
            for e in self.pattern.edges:
                if e.src == old:
                    e.src = name
                if e.dst == old:
                    e.dst = name
        if types:
            v = self.pattern.vertices[name]
            v.types = v.types & self._vertex_constraint(types)
        self._cur = name
        return self

    def at(self, alias: str) -> "GraphIrBuilder":
        """Move the cursor to a bound vertex (Gremlin ``select``)."""
        self._begin("at")
        if alias not in self.pattern.vertices:
            raise self._err(f"unknown alias {alias!r}; pattern aliases: "
                            f"{sorted(self.pattern.vertices)}")
        self._cur = alias
        return self

    def join(self, other: "GraphIrBuilder") -> "GraphIrBuilder":
        """Merge another builder's pattern and predicates into this one
        (multi-MATCH composition).  Shared vertex aliases intersect their
        constraints; edge aliases must not collide."""
        self._begin("join")
        self._require_open_pattern("join")
        if other._pending is not None or other._rel_ops:
            raise self._err("joined builder must be a bare pattern "
                            "(no pending expand, no relational steps)")
        clash = self._edge_aliases() & other._edge_aliases()
        named_clash = {a for a in clash if not a.startswith("_")}
        if named_clash:
            raise self._err(f"edge aliases {sorted(named_clash)} bound on "
                            "both sides of join()")
        # anonymous aliases are builder-local: a collision means two
        # *distinct* anonymous elements that happen to share a minted name,
        # so re-mint the other side's (named vertex collisions, by contrast,
        # are the join keys and merge intentionally)
        taken = (set(self.pattern.vertices) | set(other.pattern.vertices)
                 | self._edge_aliases() | other._edge_aliases())
        vmap: dict[str, str] = {}
        for a in other.pattern.vertices:
            if a.startswith("_") and a in self.pattern.vertices:
                na = self._fresh("v")
                while na in taken:
                    na = self._fresh("v")
                vmap[a] = na
                taken.add(na)
        for e in other.pattern.edges:
            if e.alias in clash:
                na = self._fresh("e")
                while na in taken:
                    na = self._fresh("e")
                vmap[e.alias] = na
                taken.add(na)
        for a, v in other.pattern.vertices.items():
            mine = self.pattern.add_vertex(vmap.get(a, a), v.types)
            mine.predicates.extend(ir.subst_aliases(p, vmap)
                                   for p in v.predicates)
        for e in other.pattern.edges:
            self.pattern.add_edge(PatternEdge(
                vmap.get(e.alias, e.alias), vmap.get(e.src, e.src),
                vmap.get(e.dst, e.dst), e.triples, e.direction, e.hops,
                [ir.subst_aliases(p, vmap) for p in e.predicates]))
        self._preds.extend(ir.subst_aliases(p, vmap) for p in other._preds)
        self._declared |= other._declared
        self._consumed.update(other._consumed)
        for k, v in other._params.items():
            self._params.setdefault(k, v)
        return self

    # ----------------------------------------------------- relational steps
    def select(self, predicate) -> "GraphIrBuilder":
        """Add a filter conjunct (all conjuncts form one SELECT op placed
        right after the pattern — so it must precede project/group/order)."""
        self._begin("select")
        if self._pending is not None:
            raise self._err("select() while an expand() awaits get_vertex()")
        if self._rel_ops:
            raise self._err(
                "select() must precede relational steps — filtering an "
                "aggregation's output (HAVING) is not supported")
        self._validate_expr(predicate)
        self._preds.append(predicate)
        return self

    where = select          # frontend-facing synonym

    @staticmethod
    def _named(items, default=lambda e: repr(e)):
        out = []
        for it in items:
            if isinstance(it, tuple):
                out.append(it)
            else:
                out.append((it, default(it)))
        return out

    def project(self, items, distinct: bool = False) -> "GraphIrBuilder":
        self._begin("project")
        items = self._named(items)
        for e, _ in items:
            self._validate_expr(e)
        self._rel_ops.append(ir.Project(items, distinct=distinct))
        self._out_names.update(n for _, n in items)
        return self

    def group(self, keys, aggs) -> "GraphIrBuilder":
        """GROUP: ``keys``/``aggs`` are (expr, out_name) pairs."""
        self._begin("group")
        keys = self._named(keys)
        aggs = self._named(aggs)
        for e, _ in keys:
            self._validate_expr(e)
        for a, _ in aggs:
            if not isinstance(a, ir.Agg):
                raise self._err(f"group aggregate must be ir.Agg, got {a!r}")
            self._validate_expr(a)
        self._rel_ops.append(ir.GroupBy(keys, aggs))
        self._out_names.update(n for _, n in keys)
        self._out_names.update(n for _, n in aggs)
        return self

    def order(self, items, limit: int | None = None) -> "GraphIrBuilder":
        """ORDER BY: items are (expr, ascending) pairs (bare expr == ASC).
        Expressions may reference output columns of a prior project/group."""
        self._begin("order")
        norm = []
        for it in items:
            e, asc = it if isinstance(it, tuple) else (it, True)
            self._validate_expr(e, allow_outputs=True)
            norm.append((e, bool(asc)))
        self._rel_ops.append(ir.OrderBy(norm, limit=limit))
        return self

    def limit(self, n: int) -> "GraphIrBuilder":
        self._begin("limit")
        n = int(n)
        if n < 0:
            raise self._err(f"LIMIT must be >= 0, got {n}")
        self._rel_ops.append(ir.Limit(n))
        return self

    # ----------------------------------------------------------------- build
    def build(self) -> ir.LogicalPlan:
        self._begin("build")
        if self._pending is not None:
            raise self._err("dangling expand(): call get_vertex() first")
        if not self.pattern.vertices:
            raise self._err("empty pattern: add at least one scan()")
        ops: list = [ir.MatchPattern(self.pattern)]
        pred = ir.make_and(self._preds)
        if pred is not None:
            ops.append(ir.Select(pred))
        ops.extend(self._rel_ops)
        plan = ir.LogicalPlan(ops, dict(self._params))
        # which bindings were consumed *structurally* (baked into the
        # pattern shape): the engine refuses to rebind exactly these, and
        # the prepared-plan caches key their variants on them
        plan.hints["structural_params"] = dict(self._consumed)
        return plan
