"""The port's embedding bag (``repro_torch.kernels.embedding_bag``: the
plain version that CPU tensors run, and the CUDA kernel on the card) held
against the reference: the Pallas kernel in interpret mode and its jnp
oracle over the ``test_embedding_bag_sweep`` shapes, a seeded grid in
place of the reference's hypothesis property, out-of-range ids against
``embedding_bag_pallas`` itself, bf16 tables and empty inputs.  Tolerance
1e-4 in fp32, the reference's; 1e-2 in bf16, where the output rounds once
to 8 bits of mantissa (2^-8 relative).  The kernel's tests on the card are
in ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.embedding_bag import embedding_bag_pallas
from repro.kernels.embedding_bag.ops import embedding_bag as pallas_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jnp_bag
from repro_torch import kernels
from repro_torch.kernels.embedding_bag.ops import embedding_bag
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
