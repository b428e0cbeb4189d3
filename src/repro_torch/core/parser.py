"""Cypher-subset frontend (paper §4.2).

Tokenizer + grammar only: parsing PatRelQuery text drives the unified
``GraphIrBuilder`` (``core/ir_builder.py``), which owns alias management,
schema-constraint lookup and eager validation.  ``$params`` are late bound —
they lower to first-class ``ir.Param`` nodes resolved at execution time, so
a parsed/optimized plan is reusable across bindings (the prepared-query
path, DESIGN.md §3).  The only exception is *structural* parameters (hop
counts ``*$h``), which change the pattern shape and must be bound at parse
time via the ``params`` argument; any ``params`` given here also become the
plan's default bindings and the CBO's selectivity hints.

Supported grammar (enough for every query in the paper's Appendix A):

    query     := (EXPLAIN | PROFILE)?
                 MATCH path (',' path)* (MATCH ...)* (WHERE expr)?
                 RETURN [DISTINCT] item (',' item)*
                 (ORDER BY expr [ASC|DESC] (',' ...)*)? (LIMIT int)?
    path      := node (edge node)*
    node      := '(' [alias] [':' NAME ('|' NAME)*] [props] ')'
    edge      := '-[' [alias] [':' NAME ('|' NAME)*] ['*' (int|$param)] ']->'

A Gremlin-style builder API is provided by ``repro_torch.core.gremlin``.
"""
from __future__ import annotations

import re

from repro_torch.core import ir
from repro_torch.core.ir_builder import GraphIrBuilder
from repro_torch.core.pattern import BOTH, IN, OUT
from repro_torch.core.schema import GraphSchema

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'[^']*'|"[^"]*")
  | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|<>|!=|<-|->|=|<|>|\(|\)|\[|\]|\{|\}|,|:|\||\*|\.|-)
""", re.X)

_KEYWORDS = {"MATCH", "WHERE", "RETURN", "ORDER", "BY", "LIMIT", "AS", "AND",
             "OR", "NOT", "IN", "DISTINCT", "ASC", "DESC", "COUNT", "SUM",
             "MIN", "MAX", "AVG"}


def _tokenize(text: str):
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "name" and val.upper() in _KEYWORDS:
            toks.append(("kw", val.upper()))
        else:
            toks.append((kind, val))
    toks.append(("eof", ""))
    return toks


class CypherParser:
    def __init__(self, schema: GraphSchema, params: dict | None = None):
        self.schema = schema
        self.b = GraphIrBuilder(schema, params)

    # ------------------------------------------------------------------ util
    def _peek(self):
        return self.toks[self.i]

    def _next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def _accept(self, kind, val=None):
        k, v = self._peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return v
        return None

    def _expect(self, kind, val=None):
        got = self._accept(kind, val)
        if got is None:
            raise SyntaxError(f"expected {val or kind}, got {self._peek()}")
        return got

    # ----------------------------------------------------------------- parse
    def parse(self, text: str) -> ir.LogicalPlan:
        self.toks = _tokenize(text)
        self.i = 0
        b = self.b
        # EXPLAIN/PROFILE prefix: parse the query as usual, record the
        # requested mode as a plan hint (GOpt.run routes it to explain();
        # the hint is not part of the canonical form, so the underlying
        # query shares its cached plan with the plain form).  Recognized
        # positionally — only as the very first token — so identifiers
        # named "explain"/"profile" stay valid everywhere else.
        explain_mode = None
        k, v = self._peek()
        if k == "name" and v.upper() in ("EXPLAIN", "PROFILE"):
            self._next()
            explain_mode = v.lower()
            k2, v2 = self._peek()
            if (explain_mode == "profile" and k2 == "name"
                    and v2.upper() == "SYNC"):
                self._next()                 # PROFILE SYNC: per-op device sync
                explain_mode = "profile_sync"
        saw_match = False
        while self._accept("kw", "MATCH"):
            saw_match = True
            self._parse_path()
            while self._accept("op", ","):
                self._parse_path()
        if not saw_match:
            raise SyntaxError("query must start with MATCH")

        if self._accept("kw", "WHERE"):
            b.select(self._expr())

        self._expect("kw", "RETURN")
        distinct = bool(self._accept("kw", "DISTINCT"))
        items = [self._return_item()]
        while self._accept("op", ","):
            items.append(self._return_item())

        has_agg = any(isinstance(e, ir.Agg) for e, _ in items)
        if has_agg:
            b.group([(e, n) for e, n in items if not isinstance(e, ir.Agg)],
                    [(e, n) for e, n in items if isinstance(e, ir.Agg)])
        else:
            b.project(items, distinct=distinct)

        if self._accept("kw", "ORDER"):
            self._expect("kw", "BY")
            oitems = [self._order_item(items)]
            while self._accept("op", ","):
                oitems.append(self._order_item(items))
            b.order(oitems)
        if self._accept("kw", "LIMIT"):
            b.limit(int(self._expect("num")))
        self._expect("eof")
        plan = b.build()
        if explain_mode is not None:
            plan.hints["explain"] = explain_mode
        return plan

    # ------------------------------------------------------------- patterns
    def _parse_path(self):
        alias, types, props = self._node()
        self.b.scan(alias, types)
        self._node_props(self.b.current, props)
        while self._peek() in (("op", "-"), ("op", "<-")):
            direction, ealias, labels, hops = self._edge()
            nalias, ntypes, nprops = self._node()
            self.b.expand(labels, direction=direction, alias=ealias,
                          hops=hops)
            self.b.get_vertex(nalias, ntypes)
            self._node_props(self.b.current, nprops)

    def _node_props(self, alias: str, props: list):
        for prop, val in props:
            self.b.select(ir.Cmp("=", ir.Prop(alias, prop), val))

    def _node(self):
        """Grammar only: returns (alias|None, types|None, [(prop, value)])."""
        self._expect("op", "(")
        alias = self._accept("name")
        types = None
        if self._accept("op", ":"):
            types = [self._expect("name").upper()]
            while self._accept("op", "|"):
                types.append(self._expect("name").upper())
        props = []
        if self._peek() == ("op", "{"):
            self._next()
            while True:
                prop = self._expect("name")
                self._expect("op", ":")
                props.append((prop, self._value()))
                if not self._accept("op", ","):
                    break
            self._expect("op", "}")
        self._expect("op", ")")
        return alias, types, props

    def _edge(self):
        """Returns (direction, alias|None, labels|None, hops)."""
        left = self._accept("op", "<-")
        if left is None:
            self._expect("op", "-")
        alias, labels, hops = None, None, 1
        if self._accept("op", "["):
            alias = self._accept("name")
            if self._accept("op", ":"):
                labels = [self._expect("name").upper()]
                while self._accept("op", "|"):
                    labels.append(self._expect("name").upper())
            if self._accept("op", "*"):
                k, v = self._peek()
                if k == "num":
                    hops = int(self._next()[1])
                elif k == "param":
                    hops = self._next()[1]    # structural: builder resolves
                else:
                    raise SyntaxError("EXPAND_PATH needs an explicit hop "
                                      "count")
            self._expect("op", "]")
        if left:
            self._expect("op", "-")
            return IN, alias, labels, hops
        # either -> or -
        if self._accept("op", "->"):
            return OUT, alias, labels, hops
        self._expect("op", "-")
        return BOTH, alias, labels, hops

    # ----------------------------------------------------------- expressions
    def _return_item(self):
        e = self._expr()
        name = None
        if self._accept("kw", "AS"):
            name = self._expect("name")
        if name is None:
            name = repr(e)
        return (e, name)

    def _order_item(self, ritems):
        e = self._expr()
        asc = True
        if self._accept("kw", "DESC"):
            asc = False
        else:
            self._accept("kw", "ASC")
        # normalize: ordering by a RETURN expression refers to its output
        # column (e.g. ORDER BY count(v1) with RETURN count(v1) AS cnt)
        for re_, rn in ritems:
            if e == re_:
                return (ir.Var(rn), asc)
        return (e, asc)

    def _expr(self):
        return self._or()

    def _or(self):
        l = self._and()
        args = [l]
        while self._accept("kw", "OR"):
            args.append(self._and())
        return args[0] if len(args) == 1 else ir.BoolOp("OR", tuple(args))

    def _and(self):
        l = self._not()
        args = [l]
        while self._accept("kw", "AND"):
            args.append(self._not())
        return args[0] if len(args) == 1 else ir.BoolOp("AND", tuple(args))

    def _not(self):
        if self._accept("kw", "NOT"):
            return ir.BoolOp("NOT", (self._not(),))
        return self._cmp()

    def _cmp(self):
        l = self._atom()
        k, v = self._peek()
        if k == "op" and v in ("=", "<>", "!=", "<", ">", "<=", ">="):
            self._next()
            r = self._atom()
            return ir.Cmp("<>" if v == "!=" else v, l, r)
        if k == "kw" and v == "IN":
            self._next()
            return ir.InSet(l, self._value_list())
        return l

    def _value_list(self):
        k, v = self._peek()
        if k == "param":
            self._next()
            return self.b.param(v)           # whole-list parameter
        self._expect("op", "[")
        vals = [self._literal()]
        while self._accept("op", ","):
            vals.append(self._literal())
        self._expect("op", "]")
        return tuple(vals)

    def _literal(self):
        k, v = self._next()
        if k == "num":
            return float(v) if "." in v else int(v)
        if k == "str":
            return v[1:-1]
        raise SyntaxError(f"expected literal, got {v!r}")

    def _value(self):
        """A literal or a late-bound parameter, as an expression node."""
        if self._peek()[0] == "param":
            return self.b.param(self._next()[1])
        return ir.Lit(self._literal())

    def _atom(self):
        k, v = self._peek()
        if k in ("num", "str"):
            return ir.Lit(self._literal())
        if k == "param":
            self._next()
            return self.b.param(v)
        if k == "op" and v == "(":
            self._next()
            e = self._expr()
            self._expect("op", ")")
            return e
        if k == "kw" and v in ("COUNT", "SUM", "MIN", "MAX", "AVG"):
            self._next()
            self._expect("op", "(")
            self._accept("kw", "DISTINCT")
            if self._accept("op", "*"):
                arg = None
            else:
                arg = self._expr()
            self._expect("op", ")")
            return ir.Agg(v, arg)
        if k == "name":
            self._next()
            if self._accept("op", "."):
                prop = self._expect("name")
                return ir.Prop(v, prop)
            return ir.Var(v)
        raise SyntaxError(f"unexpected token {v!r} in expression")


def parse_cypher(text: str, schema: GraphSchema,
                 params: dict | None = None) -> ir.LogicalPlan:
    return CypherParser(schema, params).parse(text)
