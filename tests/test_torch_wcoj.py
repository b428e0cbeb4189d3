"""The port's WCOJ membership probe (``repro_torch.kernels.wcoj_intersect``)
held against the reference: the Pallas kernel in interpret mode and its
jnp oracle over the ``test_wcoj_shapes`` sweep, and the reference numpy and
jax operator sets' ``intersect`` on real store CSRs — including rows above
the reference's ``MAX_ELL_DEGREE`` (its binary-search path).  Exact
equality throughout: the probe is integer work."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schema import EdgeTriple, motivating_schema
from repro.graphdb.jax_backend import MAX_ELL_DEGREE, JaxOperators
from repro.graphdb.numpy_backend import NumpyOperators
from repro.graphdb.storage import build_store
from repro.kernels.wcoj_intersect.ops import wcoj_intersect as pallas_probe
from repro.kernels.wcoj_intersect.ref import wcoj_intersect_ref as jnp_probe
from repro_torch import kernels
from repro_torch.core.schema import EdgeTriple as PortTriple
from repro_torch.graphdb.storage import export_store, import_store
from repro_torch.graphdb.torch_backend import TorchOperators
from repro_torch.kernels.wcoj_intersect.ops import wcoj_intersect
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))


def _ell_case(R, D, seed):
    """The reference sweep's padded-ELL input (sorted rows, -1 pad), plus
    a few -2 padding targets as the reference backend feeds."""
    rng = np.random.default_rng(seed)
    adj = np.sort(rng.integers(0, 5 * D, size=(R, D)), axis=1)
    deg = rng.integers(0, D + 1, size=R)
    adj = np.where(np.arange(D)[None] < deg[:, None], adj, -1)
    adj = np.where(adj < 0, np.iinfo(np.int32).max, adj)
    adj = np.sort(adj, axis=1)
    adj[adj == np.iinfo(np.int32).max] = -1
    tgt = rng.integers(0, 5 * D, size=R).astype(np.int32)
    hit = deg > 0
    tgt[hit] = adj[np.arange(R), np.maximum(deg - 1, 0)][hit]
    tgt[rng.random(R) < 0.05] = -2
    return adj.astype(np.int32), tgt


def _ell_to_csr(adj):
    valid = adj >= 0
    indptr = np.concatenate([[0], np.cumsum(valid.sum(axis=1))])
    return indptr, adj[valid]


@pytest.mark.parametrize("R,D", [(64, 16), (300, 64), (17, 128), (512, 8)])
def test_plain_probe_matches_pallas_and_jnp_oracle(R, D):
    adj, tgt = _ell_case(R, D, seed=R * D)
    f1, p1 = pallas_probe(jnp.asarray(adj), jnp.asarray(tgt), block_rows=64,
                          interpret=True)
    f2, p2 = jnp_probe(jnp.asarray(adj), jnp.asarray(tgt))
    indptr, indices = _ell_to_csr(adj)
    rows = np.arange(R)
    # without a pos map the edge position is the hit's flat slot
    found, epos = wcoj_intersect(_t(indptr), _t(indices), _t(rows), _t(tgt))
    found, epos = found.numpy(), epos.numpy()
    assert found.dtype == np.bool_
    # the reference reports the position within the row (-1 when absent)
    in_row = np.where(found, epos - indptr[rows], -1)
    for f, p in ((f1, p1), (f2, p2)):
        np.testing.assert_array_equal(found, np.asarray(f).astype(bool))
        np.testing.assert_array_equal(in_row, np.asarray(p))
    assert (epos[~found] == 0).all()


def test_lower_bound_edges():
    """First match in a row that repeats a value, empty rows, the last
    row, -2 padding targets and targets past every value."""
    indptr = np.array([0, 4, 4, 7, 9])
    indices = np.array([2, 5, 5, 9, 1, 3, 8, 4, 11])
    pos = np.array([8, 7, 6, 5, 4, 3, 2, 1, 0])
    rows = np.array([0, 0, 1, 2, 3, 3, 3, 0, 2])
    tgt = np.array([5, 9, 5, 8, 11, 4, -2, 10, 0])
    want_found = [True, True, False, True, True, True, False, False, False]
    found, epos = wcoj_intersect(_t(indptr), _t(indices), _t(rows), _t(tgt),
                                 _t(pos))
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(epos.numpy(), [7, 5, 0, 2, 0, 1, 0, 0, 0])
    # without a map: the flat slots of the hits
    found, slot = wcoj_intersect(_t(indptr), _t(indices), _t(rows), _t(tgt))
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(slot.numpy(), [1, 3, 0, 6, 8, 7, 0, 0, 0])
    # an empty CSR: nothing is found anywhere
    f, e = wcoj_intersect(_t([0, 0, 0]), _t([]), _t([0, 1]), _t([3, 0]))
    assert not f.any() and (e == 0).all()


def test_wrapper_rejects_bad_inputs():
    ip, ix = _t([0, 1]), _t([3])
    with pytest.raises(TypeError):
        wcoj_intersect(ip.long(), ix, _t([0]), _t([3]))
    with pytest.raises(ValueError):
        wcoj_intersect(ip, ix, _t([0, 0]), _t([3]))
    with pytest.raises(ValueError):
        wcoj_intersect(ip, ix, _t([0]), _t([3]), pos_map=_t([0, 1]))
    with pytest.raises(ValueError):
        wcoj_intersect(ip, ix, _t([0, 9, 0, 9])[::2], _t([3, 3]))


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    before = kernels.LAUNCHES.get("wcoj_intersect", 0)
    args = (_t([0, 2]), _t([1, 4]), _t([0, 0]), _t([4, 2]))
    got = wcoj_intersect(*args)
    want = wcoj_intersect_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES.get("wcoj_intersect", 0) == before


@pytest.fixture(scope="module")
def hub_store():
    """A store with a hub whose in-degree exceeds the reference's ELL
    ceiling, so the reference jax set takes its binary-search path."""
    rng = np.random.default_rng(11)
    sch = motivating_schema()
    n = {"PERSON": 3000, "PRODUCT": 40, "PLACE": 6}
    E = EdgeTriple
    m = 9000
    buyer = rng.integers(0, n["PERSON"], m)
    item = np.where(rng.random(m) < 0.4, 0, rng.integers(0, n["PRODUCT"], m))
    knows = (rng.integers(0, n["PERSON"], 20000),
             rng.integers(0, n["PERSON"], 20000))
    edges = {E("PERSON", "PURCHASES", "PRODUCT"): (buyer, item),
             E("PERSON", "KNOWS", "PERSON"): knows,
             E("PERSON", "LOCATEDIN", "PLACE"): (
                 np.arange(n["PERSON"]), rng.integers(0, n["PLACE"],
                                                      n["PERSON"])),
             E("PRODUCT", "PRODUCEDIN", "PLACE"): (
                 np.arange(n["PRODUCT"]), rng.integers(0, n["PLACE"],
                                                       n["PRODUCT"]))}
    return build_store(sch, n, edges)


@pytest.mark.parametrize("direction", ["in", "out"])
def test_operator_probe_matches_reference_sets(hub_store, direction):
    ref = hub_store
    port = import_store(export_store(ref))
    t = EdgeTriple("PERSON", "PURCHASES", "PRODUCT")
    keyed, other = (("PRODUCT", "PERSON") if direction == "in"
                    else ("PERSON", "PRODUCT"))
    csr_ref = (ref.in_csr if direction == "in" else ref.out_csr)[t]
    csr_port = (port.in_csr if direction == "in"
                else port.out_csr)[PortTriple(t.src, t.label, t.dst)]
    deg = np.diff(csr_ref.indptr)
    if direction == "in":
        assert deg.max() > MAX_ELL_DEGREE
    rng = np.random.default_rng(5)
    n = 4000
    rows = rng.integers(0, ref.v_count[keyed], n)
    lo, hi = ref.type_range(other)
    tgt = rng.integers(lo, hi, n)
    # aim half the probes at real neighbours
    has = deg[rows] > 0
    aim = has & (rng.random(n) < 0.5)
    pick = csr_ref.indptr[rows] + (rng.random(n) * deg[rows]).astype(int)
    tgt[aim] = csr_ref.indices[pick[aim]]
    f_np, e_np = NumpyOperators(ref).intersect(csr_ref, rows, tgt)
    jops = JaxOperators(ref)
    f_jx, e_jx = jops.intersect(csr_ref, jops.asarray(rows),
                                jops.asarray(tgt))
    tops = TorchOperators(port, device="cpu")
    f_t, e_t = tops.intersect(csr_port, tops.asarray(rows), tops.asarray(tgt))
    assert f_t.dtype == torch.bool and e_t.dtype == torch.int32
    f_t, e_t = tops.to_host(f_t), tops.to_host(e_t)
    assert f_t.any() and not f_t.all()
    np.testing.assert_array_equal(f_t, f_np)
    np.testing.assert_array_equal(e_t, e_np)
    np.testing.assert_array_equal(f_t, np.asarray(f_jx))
    np.testing.assert_array_equal(e_t, np.asarray(e_jx))


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """On CUDA tensors the wrapper launches the kernel (counted), and the
    kernel equals the plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    adj, tgt = _ell_case(4096, 256, seed=3)
    indptr, indices = _ell_to_csr(adj)
    rng = np.random.default_rng(3)
    pos = rng.permutation(indices.shape[0])
    args = [_t(a).cuda() for a in (indptr, indices, np.arange(4096), tgt,
                                   pos)]
    before = kernels.LAUNCHES.get("wcoj_intersect", 0)
    got = wcoj_intersect(*args)
    assert kernels.LAUNCHES["wcoj_intersect"] == before + 1
    want = wcoj_intersect_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
