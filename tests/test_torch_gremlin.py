"""The port's Gremlin front end (``repro_torch.core.gremlin``), the twin of
the reference's Gremlin tests: ``test_cypher_gremlin_same_counts``
(``tests/test_system.py``), ``test_cypher_gremlin_identical_gir`` and
``test_gremlin_plan_prepare_reuses_across_bindings``
(``tests/test_prepared.py``) and the Gremlin half of
``test_frontend_backend_parity_matrix`` (``tests/test_physical_spec.py``),
on the port's ``torch[cpu]`` and ``numpy`` specs.  Also: for every parity
traversal, built step by step with both packages, the port's canonical GIR
equals the reference's.  Tolerance: exact equality."""
import types

import numpy as np
import pytest

import repro.core.gremlin as ref_gremlin
import repro.core.ir as ref_ir
import repro.core.schema as ref_schema
import repro_torch.core.gremlin as port_gremlin
import repro_torch.core.ir as port_ir
import repro_torch.core.schema as port_schema
from benchmarks import queries as Q
from repro_torch.core.gopt import GOpt
from repro_torch.core.parser import parse_cypher
from repro_torch.graphdb.storage import export_store, import_store

PORT = types.SimpleNamespace(g=port_gremlin.g, ir=port_ir,
                             sch=port_schema.ldbc_schema())
REF = types.SimpleNamespace(g=ref_gremlin.g, ir=ref_ir,
                            sch=ref_schema.ldbc_schema())


def _agg(m, fn, alias=None):
    return m.ir.Agg(fn, m.ir.Var(alias) if alias else None)


# The Appendix-A queries expressible in both frontends, as the reference's
# ``tests/test_prepared.py`` builds them: name -> (cypher text, params,
# traversal factory over a package ``m``).
def _qt1(m):
    return (m.g(m.sch).V().as_("p").in_("HASCREATOR").as_("m")
            .in_("CONTAINEROF").as_("f").count("p", as_="COUNT(p)"))


def _qt2(m):
    return (m.g(m.sch).V().as_("p").out().as_("o", types=["ORGANISATION"])
            .out().as_("c", types=["COUNTRY"]).count("p", as_="COUNT(p)"))


def _qt3(m):
    return (m.g(m.sch).V().as_("p").in_("ISLOCATEDIN").as_("x")
            .out().as_("t", types=["TAG"]).select("p")
            .count("p", as_="COUNT(p)"))


def _qr3(m):
    return (m.g(m.sch).V("PERSON").as_("author").in_("HASCREATOR")
            .as_("msg1", types=["POST", "COMMENT"])
            .count("author", as_="COUNT(author)"))


def _qr5(m):
    C, P = m.ir.Cmp, m.ir.Prop
    t = m.g(m.sch)
    (t.V("PERSON").as_("p1").out("KNOWS").as_("p2", types=["PERSON"])
     .where(C("=", P("p1", "id"), t.param("id1")))
     .where(C("=", P("p2", "id"), t.param("id2"))))
    return t.count("p1", as_="COUNT(p1)")


def _qc1a(m):
    return (m.g(m.sch).V("POST", "COMMENT").as_("message")
            .out("HASCREATOR").as_("person", types=["PERSON"])
            .select("message").out("HASTAG").as_("tag", types=["TAG"])
            .select("person").out("HASINTEREST").as_("tag")
            .count("person", as_="COUNT(person)"))


def _qc3a(m):
    return (m.g(m.sch).V("PERSON").as_("person1").in_("HASCREATOR")
            .as_("comment", types=["COMMENT"]).out("REPLYOF")
            .as_("post", types=["POST"]).in_("CONTAINEROF")
            .as_("forum", types=["FORUM"]).out("HASMEMBER")
            .as_("person2", types=["PERSON"])
            .count("person1", as_="COUNT(person1)"))


def _ic1(m):
    C, P, V = m.ir.Cmp, m.ir.Prop, m.ir.Var
    t = m.g(m.sch)
    (t.V("PERSON").as_("p").out_path(2, "KNOWS", direction="BOTH")
     .as_("friend", types=["PERSON"])
     .where(C("=", P("p", "id"), t.param("pid"))))
    return (t.group_by([(V("friend"), "friend")],
                       [(_agg(m, "COUNT", "p"), "c")])
            .order_by((V("c"), False)).limit(20).plan())


def _ic3(m):
    C, P, V = m.ir.Cmp, m.ir.Prop, m.ir.Var
    t = m.g(m.sch)
    (t.V("PERSON").as_("p").both("KNOWS").as_("friend", types=["PERSON"])
     .in_("HASCREATOR").as_("m", types=["POST", "COMMENT"])
     .out("HASTAG").as_("t", types=["TAG"])
     .where(C("=", P("p", "id"), t.param("pid"))))
    return (t.group_by([(V("friend"), "friend")],
                       [(_agg(m, "COUNT", "m"), "cnt")])
            .order_by((V("cnt"), False)).limit(20).plan())


def _ic11(m):
    C, P, V = m.ir.Cmp, m.ir.Prop, m.ir.Var
    t = m.g(m.sch)
    (t.V("PERSON").as_("p").both("KNOWS").as_("friend", types=["PERSON"])
     .out("WORKAT").as_("org", types=["ORGANISATION"])
     .out("ISLOCATEDIN").as_("c", types=["COUNTRY"])
     .where(C("=", P("p", "id"), t.param("pid"))))
    return (t.group_by([(V("friend"), "friend"), (V("org"), "org")],
                       [(_agg(m, "COUNT", "c"), "n")])
            .order_by((V("n"), True)).limit(10).plan())


PARITY = {
    "Qt1": (Q.QT["Qt1"], None, _qt1),
    "Qt2": (Q.QT["Qt2"], None, _qt2),
    "Qt3": (Q.QT["Qt3"], None, _qt3),
    "Qr3": (Q.QR["Qr3"], None, _qr3),
    "Qr5": (Q.QR["Qr5"], Q.QR_PARAMS["Qr5"], _qr5),
    "Qc1a": (Q.QC["Qc1a"], None, _qc1a),
    "Qc3a": (Q.QC["Qc3a"], None, _qc3a),
    "ic1": (Q.QIC["ic1"], Q.QIC_PARAMS["ic1"], _ic1),
    "ic3": (Q.QIC["ic3"], Q.QIC_PARAMS["ic3"], _ic3),
    "ic11": (Q.QIC["ic11"], Q.QIC_PARAMS["ic11"], _ic11),
}


def _table_eq(a, b):
    assert a.nrows == b.nrows
    assert set(a.cols) == set(b.cols)
    for k in a.cols:
        x, y = np.asarray(a.cols[k]), np.asarray(b.cols[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def port_small(small_ldbc):
    return import_store(export_store(small_ldbc))


@pytest.fixture(scope="module")
def gopt_cpu(port_small):
    return GOpt(port_small, device="cpu")


# ----------------------------------------------------------- frontend parity

def test_cypher_gremlin_same_counts(tiny_store):
    store = import_store(export_store(tiny_store))
    gopt = GOpt(store, device="cpu")
    qc = ("MATCH (a:PERSON)-[:PURCHASES]->(p:PRODUCT) "
          "RETURN count(a) AS c")
    t1, _ = gopt.execute(gopt.optimize(qc))
    plan = (port_gremlin.g(store.schema).V("PERSON").as_("a")
            .out("PURCHASES").as_("p", types=["PRODUCT"]).count("a"))
    t2, _ = gopt.execute(gopt.optimize(plan))
    assert int(t1.cols["c"][0]) == int(t2.cols["count"][0]) > 0


@pytest.mark.parametrize("name", sorted(PARITY))
def test_cypher_gremlin_identical_gir(name):
    text, _, make_traversal = PARITY[name]
    cy = port_ir.canonical_form(parse_cypher(text, PORT.sch))
    gr = port_ir.canonical_form(make_traversal(PORT))
    assert cy == gr, f"{name}: frontends disagree\n{cy}\n----\n{gr}"


@pytest.mark.parametrize("name", sorted(PARITY))
def test_gremlin_gir_equals_the_reference(name):
    """The same traversal built with the port's ``g`` and the reference's
    has one canonical GIR."""
    _, _, make_traversal = PARITY[name]
    assert port_ir.canonical_form(make_traversal(PORT)) == \
        ref_ir.canonical_form(make_traversal(REF))


@pytest.mark.parametrize("name", ["Qr5", "ic3", "ic11"])
def test_gremlin_rows_equal_cypher_rows(gopt_cpu, name):
    """A prepared traversal answers as its Cypher twin, and both share
    one cached plan (identical GIR)."""
    text, params, make_traversal = PARITY[name]
    ref, _ = gopt_cpu.prepare(text).execute(params)
    pq = gopt_cpu.prepare(make_traversal(PORT))
    tbl, _ = pq.execute(params)
    _table_eq(ref, tbl)
    assert pq is gopt_cpu.prepare(text)


def test_gremlin_plan_prepare_reuses_across_bindings(gopt_cpu):
    """Plan inputs (no query text) still hit the plan cache across value
    bindings: the cache key is the canonical GIR, not the bindings."""
    _, _, make = PARITY["ic3"]
    gopt_cpu.prepare(make(PORT), {"pid": 3})
    before = dict(gopt_cpu.compile_counters)
    pq = gopt_cpu.prepare(make(PORT), {"pid": 5})
    assert dict(gopt_cpu.compile_counters) == before
    t, _ = pq.execute({"pid": 5})
    ref, _ = gopt_cpu.run(Q.QIC["ic3"], {"pid": 5})
    _table_eq(ref, t)


def test_frontend_backend_parity_matrix(gopt_cpu):
    """The same CGP through Cypher and Gremlin gives identical (key,
    count) columns on the port's ``torch[cpu]`` and ``numpy`` specs."""
    cypher = ("MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
              "RETURN p, count(f) AS cnt ORDER BY cnt DESC, p LIMIT 25")
    schema = gopt_cpu.store.schema
    gplan = (port_gremlin.g(schema).V("PERSON").as_("p").out("KNOWS")
             .as_("f", types=["PERSON"]).group_count("p"))
    # append the same deterministic tail the Cypher query carries
    gplan.ops.append(port_ir.OrderBy([(port_ir.Var("count"), False),
                                      (port_ir.Var("p"), True)], limit=25))
    results = {}
    for frontend, lp, ccol in (("cypher", cypher, "cnt"),
                               ("gremlin", gplan, "count")):
        opt = gopt_cpu.optimize(lp)
        for backend in (gopt_cpu.spec, "numpy"):
            tbl, _ = gopt_cpu.execute(opt, backend=backend)
            results[(frontend, str(backend))] = (tbl.cols["p"],
                                                 tbl.cols[ccol])
    base_p, base_c = results[("cypher", "numpy")]
    assert base_p.shape[0] > 0
    for (fe, be), (p, c) in results.items():
        np.testing.assert_array_equal(p, base_p, err_msg=f"{fe}/{be}")
        np.testing.assert_array_equal(c, base_c, err_msg=f"{fe}/{be}")


def test_has_values_and_steps_lower_as_cypher():
    """``has`` is an equality on the current vertex, ``values`` a plain
    projection; both equal their Cypher spelling."""
    t = port_gremlin.g(PORT.sch)
    plan = (t.V("PERSON").as_("p").has("id", t.param("pid"))
            .out("KNOWS").as_("f", types=["PERSON"]).values(
                (port_ir.Var("f"), "f")))
    cy = parse_cypher("MATCH (p:PERSON)-[:KNOWS]->(f:PERSON) "
                      "WHERE p.id = $pid RETURN f", PORT.sch)
    assert port_ir.canonical_form(plan) == port_ir.canonical_form(cy)
