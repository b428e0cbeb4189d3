"""The port's embedding bag (``repro_torch.kernels.embedding_bag``: the
plain version that CPU tensors run, and the CUDA kernel on the card) held
against the reference: the Pallas kernel in interpret mode and its jnp
oracle over the ``test_embedding_bag_sweep`` shapes, a seeded grid in
place of the reference's hypothesis property, out-of-range ids against
``embedding_bag_pallas`` itself, bf16 tables and empty inputs.  Tolerance
1e-4 in fp32, the reference's; 1e-2 in bf16, where the output rounds once
to 8 bits of mantissa (2^-8 relative).  ``route``, which picks the
16-byte-piece kernel (``vec``) or the warp-per-bag kernel (``warp``)
before a launch, is held to its rules on CPU tensors (it reads only dtype,
shape, stride and alignment), and the strided ``out`` (the bags written
into a wider buffer's columns) against the Pallas kernel, the other
columns untouched.  The kernels' tests on the card are in
``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.embedding_bag import embedding_bag_pallas
from repro.kernels.embedding_bag.ops import embedding_bag as pallas_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jnp_bag
from repro_torch import kernels
from repro_torch.kernels.embedding_bag.ops import embedding_bag, route
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

TOL = 1e-4


def _case(B, L, V, D, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, V, size=(B, L)).astype(np.int32)
    tab = rng.normal(size=(V, D)).astype(np.float32)
    return ids, tab


def _port(ids, tab, dtype=torch.float32):
    return embedding_bag(torch.as_tensor(ids), torch.as_tensor(tab).to(dtype))


@pytest.mark.parametrize("B,L,V,D", [(100, 6, 1000, 32), (32, 1, 64, 8),
                                     (7, 12, 333, 16)])
def test_matches_pallas_kernel_and_oracle(B, L, V, D):
    ids, tab = _case(B, L, V, D, B + V)
    got = _port(ids, tab)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    kern = pallas_bag(jnp.asarray(ids), jnp.asarray(tab), block_b=32,
                      block_v=128, interpret=True)
    oracle = jnp_bag(jnp.asarray(ids), jnp.asarray(tab))
    for want in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


_GRID = [tuple(int(x) for x in t) for t in zip(
    np.random.default_rng(2024).integers(1, 51, 12),
    np.random.default_rng(2025).integers(1, 9, 12),
    np.random.default_rng(2026).integers(2, 201, 12))]


@pytest.mark.parametrize("B,L,V", _GRID)
def test_seeded_grid_matches_pallas_kernel(B, L, V):
    ids, tab = _case(B, L, V, 8, B * L * V)
    got = _port(ids, tab)
    want = pallas_bag(jnp.asarray(ids), jnp.asarray(tab), block_b=16,
                      block_v=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_out_of_range_ids_match_the_pallas_kernel():
    """Ids >= V match no table tile in the Pallas kernel and ids < -1 are
    padding there: both contribute nothing (the jnp oracle would read
    out of range instead)."""
    B, L, V, D = 32, 10, 256, 16
    rng = np.random.default_rng(5)
    ids = rng.integers(-7, V + 60, size=(B, L)).astype(np.int32)
    ids[0] = V                     # a bag of nothing but ids == V
    ids[1] = -3                    # a bag of nothing but ids < -1
    tab = rng.normal(size=(V, D)).astype(np.float32)
    assert (ids >= V).sum() > L and (ids < -1).sum() > L
    got = _port(ids, tab)
    want = embedding_bag_pallas(jnp.asarray(ids), jnp.asarray(tab),
                                block_b=16, block_v=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert not got[:2].any()


def test_bf16_table_matches_pallas_kernel():
    ids, tab = _case(64, 8, 512, 32, 9)
    got = _port(ids, tab, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = pallas_bag(jnp.asarray(ids), jnp.asarray(tab, jnp.bfloat16),
                      block_b=32, block_v=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("B,L", [(0, 4), (5, 0), (0, 0)])
def test_empty_inputs_give_zeros(B, L):
    got = embedding_bag(torch.zeros((B, L), dtype=torch.int32),
                        torch.ones((10, 4)))
    assert got.shape == (B, 4) and not got.any()


def test_wrapper_rejects_bad_inputs():
    ids, tab = torch.zeros((2, 3), dtype=torch.int32), torch.ones((10, 4))
    with pytest.raises(TypeError):
        embedding_bag(ids.long(), tab)
    with pytest.raises(TypeError):
        embedding_bag(ids, tab.double())
    with pytest.raises(ValueError):
        embedding_bag(ids[None], tab)
    with pytest.raises(ValueError):
        embedding_bag(torch.zeros((3, 2), dtype=torch.int32).t(), tab)
    with pytest.raises(ValueError):
        embedding_bag(ids, tab.to("meta"))


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    before = kernels.LAUNCHES.get("embedding_bag", 0)
    ids, tab = _case(9, 4, 50, 8, 1)
    got = _port(ids, tab)
    want = embedding_bag_ref(torch.as_tensor(ids), torch.as_tensor(tab))
    assert torch.equal(got, want)
    assert kernels.LAUNCHES.get("embedding_bag", 0) == before


def _shifted(shape, dtype, shift):
    """A contiguous tensor of ``shape`` whose base lies ``shift`` elements
    past a 64-byte aligned one."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + shift + 64, dtype=dtype)
    lead = (-buf.data_ptr() % 64) // buf.element_size()
    t = buf[lead + shift:lead + shift + n].view(shape)
    assert t.data_ptr() % 64 == shift * buf.element_size()
    return t


@pytest.mark.parametrize("D,dtype,t_shift,out_cols,want", [
    (32, torch.float32, 0, None, "vec"),      # 8 pieces: Wide & Deep
    (32, torch.bfloat16, 0, None, "vec"),     # 4 pieces
    (8, torch.float32, 0, None, "vec"),       # 2 pieces
    (8, torch.bfloat16, 0, None, "vec"),      # 1 piece
    (80, torch.float32, 0, None, "vec"),      # 20 pieces: one warp
    (128, torch.float32, 0, None, "vec"),     # 32 pieces
    (6, torch.float32, 0, None, "warp"),      # 24-byte rows
    (4, torch.bfloat16, 0, None, "warp"),     # 8-byte rows
    (80, torch.bfloat16, 0, None, "vec"),     # 10 pieces
    (32, torch.float32, 1, None, "warp"),     # base 4 bytes off
    (32, torch.bfloat16, 8, None, "vec"),     # base 16 bytes off
    (32, torch.float32, 0, 1296, "vec"),      # the deep tower's buffer
    (32, torch.float32, 0, 1293, "warp"),     # unpadded: 5172-byte rows
    (32, torch.bfloat16, 0, 1292, "warp"),    # 2584-byte rows
    (32, torch.bfloat16, 0, 1296, "vec"),
])
def test_route_decides_from_dtype_shape_stride_and_alignment(
        D, dtype, t_shift, out_cols, want):
    ids = torch.zeros((6, 3), dtype=torch.int32)
    table = _shifted((10, D), dtype, t_shift)
    out = None
    if out_cols is not None:
        out = torch.zeros((3, out_cols), dtype=dtype)[:, :2 * D]
    assert route(ids, table, out) == want


def test_route_sees_a_misaligned_output_base():
    ids = torch.zeros((4, 2), dtype=torch.int32)
    table = torch.zeros((10, 32))
    buf = torch.zeros((2, 1296))
    assert route(ids, table, buf[:, :64]) == "vec"
    assert route(ids, table, buf[:, 1:65]) == "warp"      # 4 bytes off
    assert route(ids, table, buf[:, 4:68]) == "vec"       # 16 bytes off


@pytest.mark.parametrize("G,pad,dtype", [(4, 3, torch.float32),
                                         (40, 16, torch.float32),
                                         (3, 1, torch.bfloat16)])
def test_strided_out_matches_pallas_kernel_and_leaves_the_rest(G, pad,
                                                               dtype):
    """Bags written through ``out`` (rows of ``G`` bags, then ``pad`` more
    columns) equal the Pallas kernel's, by the wrapper and by the plain
    version, and no column past the bags changes."""
    R, L, V, D = 5, 7, 300, 16
    ids, tab = _case(R * G, L, V, D, G + pad)
    tol = 1e-2 if dtype == torch.bfloat16 else TOL
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(pallas_bag(jnp.asarray(ids), jnp.asarray(tab, jdt),
                                 block_b=16, block_v=64, interpret=True),
                      np.float32)
    for fn in (embedding_bag, embedding_bag_ref):
        buf = torch.full((R, G * D + pad), 7.0, dtype=dtype)
        view = buf[:, :G * D]
        got = fn(torch.as_tensor(ids), torch.as_tensor(tab).to(dtype),
                 out=view)
        assert got.data_ptr() == view.data_ptr()
        assert got.stride() == (G * D + pad, 1)
        np.testing.assert_allclose(
            buf[:, :G * D].float().reshape(R * G, D).numpy(), want,
            rtol=tol, atol=tol)
        assert bool((buf[:, G * D:] == 7.0).all())


def test_strided_out_equals_the_fresh_output():
    ids, tab = _case(24, 5, 90, 8, 3)
    ids_t, tab_t = torch.as_tensor(ids), torch.as_tensor(tab)
    fresh = embedding_bag(ids_t, tab_t)
    buf = torch.zeros((6, 4 * 8 + 4))
    embedding_bag(ids_t, tab_t, out=buf[:, :32])
    assert torch.equal(buf[:, :32].reshape(24, 8), fresh)


def test_out_that_does_not_hold_the_bags_is_refused():
    ids = torch.zeros((6, 2), dtype=torch.int32)
    tab = torch.ones((10, 4))
    with pytest.raises(ValueError, match="does not hold"):
        embedding_bag(ids, tab, out=torch.zeros((4, 6)))       # 6 % 4
    with pytest.raises(ValueError, match="does not hold"):
        embedding_bag(ids, tab, out=torch.zeros((2, 8)))       # 4 bags
    with pytest.raises(ValueError, match="dense and apart"):
        embedding_bag(ids, tab, out=torch.zeros((8, 3)).t())   # stride 3, 1
    with pytest.raises(TypeError, match="out must be"):
        embedding_bag(ids, tab, out=torch.zeros((3, 8),
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="out is on"):
        embedding_bag(ids, tab, out=torch.zeros((3, 8), device="meta"))
