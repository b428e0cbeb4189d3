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
from repro_torch.kernels.wcoj_intersect.ops import (INT32_MAX, NODE,
                                                    build_search_index,
                                                    search_index_size,
                                                    search_levels,
                                                    wcoj_intersect)
from repro_torch.kernels.wcoj_intersect.ops import route as wcoj_route
from repro_torch.kernels.wcoj_intersect.ref import (fence_reads,
                                                    fence_start,
                                                    fence_walk_ref,
                                                    wcoj_intersect_ref)
from _wcoj_cases import trouble_cases


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


# ------------------------------------------------ the fence route's index

@pytest.mark.parametrize("nnz", [0, 1, 2, 7, 8, 9, 63, 64, 65, 511, 512,
                                 513, 4095, 4096, 4097, 32769])
def test_search_index_layout(nnz):
    """Level 1 is ``indices[::8]``, each next level the previous one's
    ``[::8]``, until a level has at most 8 entries; the levels lie back to
    back, each padded with INT32_MAX to whole 8-entry nodes, at the
    offsets ``search_levels`` computes from nnz alone."""
    rng = np.random.default_rng(nnz)
    indices = _t(np.sort(rng.integers(0, 10 * nnz + 1, nnz)))
    index = build_search_index(indices)
    assert index.dtype == torch.int32 and index.dim() == 1
    assert index.shape[0] == search_index_size(nnz)
    levels = search_levels(nnz)
    level, end = indices, 0
    for off, n in levels:
        level = level[::NODE]
        assert n == level.shape[0] and off == end and off % NODE == 0
        assert torch.equal(index[off:off + n], level)
        end = off + -(-n // NODE) * NODE
        assert (index[off + n:end] == INT32_MAX).all()
    assert end == index.shape[0]
    assert level.shape[0] <= NODE
    assert (len(levels) == 0) == (nnz <= NODE)
    # about nnz / 7 words: the padding adds less than a node a level
    assert index.shape[0] <= nnz / (NODE - 1) + NODE * len(levels)


@pytest.mark.parametrize("node,small", [(4, 0), (8, 0), (8, None),
                                        (16, 0)])
@pytest.mark.parametrize("R,D", [(64, 16), (300, 64), (17, 128), (512, 8)])
def test_fence_walk_matches_the_oracle_on_the_ell_sweep(R, D, node, small):
    """The step-by-step model of the CUDA fence route equals the plain
    binary search exactly on the reference sweep, with and without a
    pos map: every row walked (``small=0``) at 4-, 8- and 16-key nodes,
    and as committed (short rows binary-searched)."""
    adj, tgt = _ell_case(R, D, seed=R * D)
    indptr, indices = _ell_to_csr(adj)
    args = [_t(indptr), _t(indices), _t(np.arange(R)), _t(tgt)]
    index = build_search_index(args[1], node)
    pos = _t(np.random.default_rng(D).permutation(indices.shape[0]))
    for pos_map in (None, pos):
        want = wcoj_intersect_ref(*args, pos_map)
        got = fence_walk_ref(args[0], args[1], index, *args[2:], pos_map,
                             node=node, small=small)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("small", [0, None])
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("name", sorted(trouble_cases()))
def test_fence_walk_matches_the_oracle_where_trouble_is_likely(name,
                                                               with_pos,
                                                               small):
    """Repeated values, rows sharing nodes with their neighbours, empty
    rows, -2 targets on row 0, targets above every key, nnz off whole
    nodes, degrees of 8^k and 8^k +- 1: the walk (every row walked, and
    as committed) equals the oracle."""
    indptr, indices, rows, tgt = (_t(a) for a in trouble_cases()[name])
    pos = (_t(np.random.default_rng(1).permutation(indices.shape[0]))
           if with_pos else None)
    want = wcoj_intersect_ref(indptr, indices, rows, tgt, pos)
    got = fence_walk_ref(indptr, indices, build_search_index(indices),
                         rows, tgt, pos, small=small)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert want[0].any() and not want[0].all()
    # the wrapper on CPU tensors with the index: the plain version
    got = wcoj_intersect(indptr, indices, rows, tgt, pos,
                         build_search_index(indices))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fence_reads_follow_the_start_level():
    """A row of degree <= 8 reads one or two leaf nodes; a 131,922-degree
    row reads its start level's one or two nodes and one a level below."""
    indptr = _t([0, 8, 12, 12, 131_934])
    assert fence_reads(indptr, _t([0])) == 1       # one aligned node
    assert fence_reads(indptr, _t([1])) == 1       # slots 8..11
    assert fence_reads(indptr, _t([2])) == 0       # empty
    reads = fence_reads(indptr, _t([3]))
    assert reads in (6, 7)
    assert fence_reads(indptr, _t([0, 1, 3, 3])) == 2 + 2 * reads
    # two leaf nodes: slots 6..9 straddle the grid
    assert fence_reads(_t([0, 6, 10]), _t([1])) == 2


@pytest.mark.parametrize("node", [4, 8, 16])
def test_fence_start_is_the_lowest_level_spanning_two_nodes(node):
    """The kernel's closed form (the degree's top bit, then one shift
    test) picks the lowest level whose nodes the row spans at most two
    of, for rows at every offset and of degrees around every power of
    two up to 2^31."""
    shift = node.bit_length() - 1
    rng = np.random.default_rng(node)
    deg = np.concatenate([[1, 2, 3], *[[2 ** j - 1, 2 ** j, 2 ** j + 1]
                                       for j in range(2, 31)]])
    deg = np.repeat(deg, 40)
    lo = np.array([int(rng.integers(0, 2 ** 31 - d)) for d in deg])
    lo[::4] -= lo[::4] % node ** 3          # some rows on the node grid
    lo = torch.as_tensor(lo, dtype=torch.int64)
    last = lo + torch.as_tensor(deg, dtype=torch.int64) - 1
    level, two = fence_start(lo, last, node)
    for k in range(12):
        sh = shift * (k + 1)
        span = (last >> sh) - (lo >> sh)
        assert not bool(((level == k) & (span > 1)).any())
        if k:
            sh0 = shift * k
            lower = (last >> sh0) - (lo >> sh0)
            assert bool((lower[level == k] > 1).all())
    sh = shift * (level + 1)
    assert torch.equal(two, (last >> sh) != (lo >> sh))


def _at(a, skew=0):
    """``a`` as an int32 view whose base lies ``skew`` elements past a
    32-byte boundary."""
    a = np.asarray(a, dtype=np.int32)
    buf = torch.empty(a.shape[0] + 16, dtype=torch.int32)
    off = (-buf.data_ptr() % 32) // 4 + skew
    view = buf[off:off + a.shape[0]]
    view.copy_(torch.as_tensor(a))
    return view


def test_route_rules():
    """``fence`` with an index of the CSR's size on 32-byte aligned
    bases; ``search`` without an index or on a misaligned base; an index
    of another size raises."""
    indices = _at(np.arange(200))
    index = _at(build_search_index(indices).numpy())
    assert wcoj_route(indices, index) == "fence"
    assert wcoj_route(indices, None) == "search"
    with pytest.raises(ValueError, match="index has"):
        wcoj_route(indices, index[:-8])
    with pytest.raises(ValueError, match="index has"):
        wcoj_route(indices[:100], index)
    # the same keys or index 4 or 16 bytes past a sector boundary
    for skew in (1, 4):
        assert wcoj_route(_at(np.arange(200), skew), index) == "search"
        assert wcoj_route(indices, _at(index.numpy(), skew)) == "search"
    # no index level below 9 keys: an empty index, still the fence walk
    small = _at(np.arange(8))
    assert build_search_index(small).shape == (0,)
    assert wcoj_route(small, build_search_index(small)) == "fence"


def test_wrapper_checks_the_index():
    ip, ix = _t([0, 9]), _t(np.arange(9))
    rows, tgt = _t([0]), _t([3])
    with pytest.raises(TypeError):
        wcoj_intersect(ip, ix, rows, tgt, None,
                       build_search_index(ix).long())
    with pytest.raises(ValueError, match="index has"):
        wcoj_intersect(ip, ix, rows, tgt, None, _t([0] * 16))
    before = dict(kernels.LAUNCHES)
    found, epos = wcoj_intersect(ip, ix, rows, tgt, None,
                                 build_search_index(ix))
    assert bool(found[0]) and int(epos[0]) == 3
    assert kernels.LAUNCHES == before


def test_operators_build_the_index_at_the_first_probe(hub_store):
    """``expand`` never builds the search index; the first ``intersect``
    of a CSR builds it on the operator set's device and keeps it in the
    CSR's cache entry, so the next probe reuses it."""
    port = import_store(export_store(hub_store))
    csr = port.in_csr[PortTriple("PERSON", "PURCHASES", "PRODUCT")]
    tops = TorchOperators(port, device="cpu")
    rows = tops.asarray(np.array([0, 1, 2]))
    tops.expand(csr, rows)
    assert tops._csr_dev(csr)[3] is None
    tops.intersect(csr, rows, tops.asarray(np.array([5, 6, 7])))
    index = tops._csr_dev(csr)[3]
    assert torch.equal(index, build_search_index(tops._csr_dev(csr)[1]))
    tops.intersect(csr, rows, tops.asarray(np.array([1, 2, 3])))
    assert tops._csr_dev(csr)[3] is index
    assert tops._csr_dev(csr, probe=True)[3] is index
