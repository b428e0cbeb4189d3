"""The port's grouped matmul (``repro_torch.kernels.grouped_matmul``: the
plain version that CPU tensors run, and the CUDA kernel on the card) held
against the reference's Pallas kernel in interpret mode over the
``test_grouped_matmul_sweep`` shapes, the ragged one included.
Tolerances are the reference's: 1e-4 in fp32, 3e-2 in bf16.  ``route``,
which picks the tensor-core or the scalar kernel before a launch, is held
to its rules on CPU tensors (it reads only dtype, shape, the layout flags
and alignment).
The kernels' tests on the card are in ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ops import grouped_matmul as pallas_gmm
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul, route

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


class _Elsewhere(torch.Tensor):
    """A tensor (no storage) that claims a device the port has no kernel
    for: ``meta`` is the dry run's device now (``launch/dryrun.py``), where
    the wrappers return empty outputs."""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} has no data here")


def test_rejects_what_it_cannot_take():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="does not fit"):
        grouped_matmul(x, torch.zeros(2, 5, 5))
    with pytest.raises(TypeError, match="x is"):
        grouped_matmul(x, w.double())
    with pytest.raises(ValueError, match="3-D"):
        grouped_matmul(x[0], w[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        grouped_matmul(_Elsewhere(x), _Elsewhere(w))
    out = grouped_matmul(x.to("meta"), w.to("meta"))
    assert out.device.type == "meta" and out.shape == (2, 3, 5)


def _operands(G, M, K, N, dtype, x_shift=0, w_shift=0):
    """x and w on the CPU, each viewed ``shift`` elements into a larger
    buffer (a shift of 1 bf16 element puts the base 2 bytes off)."""
    def view(shape, shift):
        n = shape[0] * shape[1] * shape[2]
        return torch.zeros(n + 8, dtype=dtype)[shift:shift + n].view(shape)
    return view((G, M, K), x_shift), view((G, K, N), w_shift)


@pytest.mark.parametrize("G,M,K,N,dtype,x_shift,w_shift,want", [
    (64, 311, 2048, 1024, torch.bfloat16, 0, 0, "tc"),     # prefill w1
    (64, 311, 1024, 2048, torch.bfloat16, 0, 0, "tc"),     # prefill w2
    (64, 8, 2048, 1024, torch.bfloat16, 0, 0, "tc"),       # decode w1
    (5, 129, 256, 192, torch.bfloat16, 0, 0, "tc"),        # ragged M
    (4, 1, 8, 8, torch.bfloat16, 0, 0, "tc"),              # smallest rows
    (64, 8, 2048, 1024, torch.float32, 0, 0, "simt"),      # fp32: no TF32
    (3, 37, 65, 50, torch.bfloat16, 0, 0, "simt"),         # K, N not % 8
    (2, 16, 64, 60, torch.bfloat16, 0, 0, "simt"),         # N not % 8
    (2, 16, 60, 64, torch.bfloat16, 0, 0, "simt"),         # K not % 8
    (2, 4, 0, 64, torch.bfloat16, 0, 0, "simt"),           # K = 0
    (2, 16, 64, 64, torch.bfloat16, 1, 0, "simt"),         # x base + 2 B
    (2, 16, 64, 64, torch.bfloat16, 0, 1, "simt"),         # w base + 2 B
    (2, 16, 64, 64, torch.bfloat16, 8, 8, "tc"),           # + 16 B
    (2, 16, 64, 64, torch.float16, 0, 0, "simt"),          # not bf16
])
def test_route_decides_from_dtype_shape_and_alignment(G, M, K, N, dtype,
                                                      x_shift, w_shift,
                                                      want):
    x, w = _operands(G, M, K, N, dtype, x_shift, w_shift)
    assert x.is_contiguous() and w.is_contiguous()
    assert route(x, w) == want


def _stored(G, M, K, N, dtype, trans_x, trans_w, x_shift=0):
    """x stored ``[G, K, M]`` with ``trans_x`` (else ``[G, M, K]``), w
    ``[G, N, K]`` with ``trans_w`` (else ``[G, K, N]``), x ``x_shift``
    elements into a larger buffer."""
    x, w = _operands(G, M, K, N, dtype, x_shift)
    if trans_x:
        x = _operands(G, K, M, N, dtype, x_shift)[0]
    if trans_w:
        w = _operands(G, N, K, N, dtype)[0]
    return x, w


@pytest.mark.parametrize("G,M,K,N,trans_x,trans_w,x_shift,dtype,want", [
    (64, 1280, 1024, 2048, False, True, 0, torch.bfloat16, "tc"),   # dx
    (64, 2048, 1280, 1024, True, False, 0, torch.bfloat16, "tc"),   # dw
    (3, 136, 72, 200, True, True, 0, torch.bfloat16, "tc"),
    (2, 16, 60, 64, True, False, 0, torch.bfloat16, "tc"),     # K % 8 != 0
    (2, 16, 64, 60, False, True, 0, torch.bfloat16, "tc"),     # N % 8 != 0
    (2, 36, 64, 48, True, False, 0, torch.bfloat16, "simt"),   # M % 8 != 0
    (2, 64, 36, 48, False, True, 0, torch.bfloat16, "simt"),   # K % 8 != 0
    (2, 64, 36, 48, True, True, 0, torch.bfloat16, "simt"),    # K % 8 != 0
    (2, 64, 64, 61, False, True, 0, torch.bfloat16, "simt"),   # N odd
    (2, 64, 64, 48, True, False, 1, torch.bfloat16, "simt"),   # x + 2 B
    (2, 64, 64, 48, True, False, 8, torch.bfloat16, "tc"),     # x + 16 B
    (2, 64, 64, 48, True, True, 0, torch.float32, "simt"),     # fp32
])
def test_route_reads_the_stored_layouts(G, M, K, N, trans_x, trans_w,
                                        x_shift, dtype, want):
    """With the layout flags ``route`` checks TMA's addressing on the
    operands as stored: each stored inner dimension a multiple of 8 (M of
    x stored [K, M], K of w stored [N, K]), N even, 16-byte aligned bases;
    what fails goes to ``simt``, which reads both layouts in place."""
    x, w = _stored(G, M, K, N, dtype, trans_x, trans_w, x_shift)
    assert x.shape == ((G, K, M) if trans_x else (G, M, K))
    assert w.shape == ((G, N, K) if trans_w else (G, K, N))
    assert route(x, w, trans_x, trans_w) == want
