"""The port's grouped matmul (``repro_torch.kernels.grouped_matmul``: the
plain version that CPU tensors run, and the CUDA kernel on the card) held
against the reference's Pallas kernel in interpret mode over the
``test_grouped_matmul_sweep`` shapes, the ragged one included.
Tolerances are the reference's: 1e-4 in fp32, 3e-2 in bf16.  The
kernel's tests on the card are in ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ops import grouped_matmul as pallas_gmm
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("G,M,K,N,dtype", [
    (4, 64, 96, 80, jnp.float32),
    (2, 128, 128, 128, jnp.float32),
    (3, 37, 65, 50, jnp.float32),
    (2, 64, 64, 64, jnp.bfloat16),
    (1, 256, 32, 16, jnp.float32),
])
def test_matches_pallas_kernel(G, M, K, N, dtype):
    rng = np.random.default_rng(G * M)
    x = rng.normal(size=(G, M, K)).astype(np.float32)
    w = rng.normal(size=(G, K, N)).astype(np.float32)
    want = pallas_gmm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                      block_m=32, block_n=32, block_k=32, interpret=True)
    got = grouped_matmul(torch.tensor(x).to(_TORCH[dtype]),
                         torch.tensor(w).to(_TORCH[dtype]))
    assert got.dtype == _TORCH[dtype] and got.shape == (G, M, N)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_rejects_what_it_cannot_take():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="does not fit"):
        grouped_matmul(x, torch.zeros(2, 5, 5))
    with pytest.raises(TypeError, match="x is"):
        grouped_matmul(x, w.double())
    with pytest.raises(ValueError, match="3-D"):
        grouped_matmul(x[0], w[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        grouped_matmul(x.to("meta"), w.to("meta"))
