"""The port's storage (``repro_torch.graphdb.storage``/``ldbc``) against the
reference: the LDBC-like generator is array-identical, and a reference
store crosses into the port through ``export_store``/``import_store`` as
the same bytes."""
import numpy as np
import pytest

from repro.graphdb.ldbc import generate_ldbc as ref_generate_ldbc
from repro.graphdb.ldbc import generate_motivating as ref_generate_motivating
from repro_torch.graphdb.ldbc import generate_ldbc, generate_motivating
from repro_torch.graphdb.storage import GraphStore, export_store, import_store


def _assert_same(a, b, path="store"):
    """Deep equality of two exported stores: dict keys, scalars, and
    arrays by value and dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("make_ref,make_port,kw", [
    (ref_generate_ldbc, generate_ldbc, {"sf": 0.15}),
    (ref_generate_ldbc, generate_ldbc, {"sf": 0.05, "seed": 3}),
    (ref_generate_motivating, generate_motivating,
     {"n_person": 50, "n_product": 20, "n_place": 8}),
])
def test_generators_are_array_identical(make_ref, make_port, kw):
    ref, port = make_ref(**kw), make_port(**kw)
    assert isinstance(port, GraphStore)
    _assert_same(export_store(ref), export_store(port))


def test_import_store_round_trips_a_reference_store(small_ldbc):
    flat = export_store(small_ldbc)
    port = import_store(flat)
    _assert_same(flat, export_store(port))
    assert port.n_vertices == small_ldbc.n_vertices
    assert port.n_edges == small_ldbc.n_edges
    assert ([repr(t) for t in port.triple_index()]
            == [repr(t) for t in small_ldbc.triple_index()])
    for t in small_ldbc.schema.vertex_types:
        assert port.type_range(t) == small_ldbc.type_range(t)
    ids = np.arange(0, small_ldbc.n_vertices, 7)
    np.testing.assert_array_equal(port.vertex_prop(ids, "id"),
                                  small_ldbc.vertex_prop(ids, "id"))
    assert (port.encode_str("firstName", "Maria")
            == small_ldbc.encode_str("firstName", "Maria"))
