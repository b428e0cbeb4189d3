"""The port's attention (``repro_torch.kernels.flash_attention``: the plain
version that CPU tensors run, and the CUDA kernel on the card) held against
the reference: the Pallas kernel in interpret mode over the
``test_flash_attention_sweep`` shapes, and the model's ``_block_attention``
with per-slot query offsets and valid lengths, a sliding window and a
softcap.  Tolerances are the reference's: 2e-3 in fp32, 2e-2 in bf16.
The kernel's tests on the card are in ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_fa
from repro.models.transformer import TransformerConfig, _block_attention
from repro_torch.kernels.flash_attention.ops import flash_attention, route

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-3


def _port(a, dtype):
    """A float32 numpy array as a port tensor of the JAX dtype's twin
    (both sides round float32 to bf16 to nearest even)."""
    return torch.tensor(np.asarray(a, np.float32)).to(_TORCH[dtype])


@pytest.mark.parametrize("B,H,Hkv,S,d,causal,window,cap,dtype", [
    (2, 4, 2, 128, 32, True, None, None, jnp.float32),
    (1, 2, 2, 96, 16, True, 24, 50.0, jnp.float32),
    (2, 2, 1, 64, 64, True, None, 30.0, jnp.float32),
    (1, 4, 4, 80, 24, True, None, None, jnp.float32),
    (1, 2, 2, 64, 32, True, None, None, jnp.bfloat16),
])
def test_matches_pallas_kernel(B, H, Hkv, S, d, causal, window, cap, dtype):
    rng = np.random.default_rng(S + d)
    q = rng.normal(size=(B, H, S, d)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    want = pallas_fa(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                     jnp.asarray(v, dtype), causal=causal, window=window,
                     softcap=cap, block_q=32, block_kv=32, interpret=True)
    # head h = kv head h // G, query group h % G (the reference's repeat)
    G = H // Hkv
    qp = q.transpose(0, 2, 1, 3).reshape(B, S, Hkv, G, d)
    kp, vp = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    got = flash_attention(_port(qp, dtype), _port(kp, dtype),
                          _port(vp, dtype), 0, S, window=window, softcap=cap)
    assert got.dtype == _TORCH[dtype] and got.shape == (B, S, Hkv, G, d)
    got = got.float().numpy().reshape(B, S, H, d).transpose(0, 2, 1, 3)
    tol = _tol(dtype)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfg(window=4096, cap=None, dtype=jnp.float32):
    return TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=64, vocab_size=16,
                             block_q=16, block_kv=16, window=window,
                             attn_softcap=cap, dtype=dtype)


@pytest.mark.parametrize("case", ["decode", "decode_window_softcap",
                                  "chunk", "prefill_window_softcap",
                                  "decode_bf16"])
def test_matches_model_block_attention(case):
    """Per-slot q_start/kv_len over a cache layout (slots at different
    positions, stale rows past kv_len), a sliding window and a softcap."""
    rng = np.random.default_rng(len(case))
    B, Skv, K, G, hd = 3, 40, 2, 2, 16
    dtype = jnp.bfloat16 if case.endswith("bf16") else jnp.float32
    local = "window" in case
    cfg = _cfg(window=6 if local else 4096, cap=30.0 if local else None,
               dtype=dtype)
    if case.startswith("decode"):
        Sq, q_start = 1, np.array([5, 23, 0], np.int32)
        kv_len = q_start + 1
    elif case == "chunk":
        Sq, q_start = 4, np.array([3, 17, 30], np.int32)
        kv_len = q_start + Sq
    else:
        Sq, q_start = Skv, np.zeros(B, np.int32)
        kv_len = np.full(B, Skv, np.int32)
    q = rng.normal(size=(B, Sq, K, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, K, hd)).astype(np.float32)
    want = _block_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                            jnp.asarray(v, dtype), cfg,
                            jnp.asarray(q_start), jnp.asarray(kv_len),
                            is_local=jnp.asarray(local))
    got = flash_attention(_port(q, dtype), _port(k, dtype), _port(v, dtype),
                          torch.tensor(q_start), torch.tensor(kv_len),
                          window=cfg.window if local else None,
                          softcap=cfg.attn_softcap)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_keys_past_kv_len_are_never_read():
    """Cache rows at or past kv_len change nothing, even when they hold
    huge values (the reference's Pallas wrapper pads with zeros and masks
    pad keys only through causality)."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(2, 1, 2, 1, 16)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(2, 12, 2, 16)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 12, 2, 16)), dtype=torch.float32)
    q_start, kv_len = torch.tensor([9, 4]), torch.tensor([6, 5])
    base = flash_attention(q, k, v, q_start, kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[0, 6:], v2[0, 6:] = 1e4, 1e4
    k2[1, 5:], v2[1, 5:] = 1e4, 1e4
    torch.testing.assert_close(flash_attention(q, k2, v2, q_start, kv_len),
                               base, rtol=0, atol=0)


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
    q = torch.zeros(1, 4, 2, 1, 16)
    kv = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, torch.zeros(1, 4, 3, 16), kv, 0, 4)
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention(q, kv.double(), kv, 0, 4)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, 0, 4, window=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(_Elsewhere(q), _Elsewhere(kv), _Elsewhere(kv), 0, 4)
    out = flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"), 0, 4)
    assert out.device.type == "meta" and out.shape == q.shape


def _misaligned(shape, dtype):
    """A contiguous tensor whose base is 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=dtype)
    off = next(i for i in range(1, 9) if (buf[i:].data_ptr() % 16) == 2)
    t = buf[off:off + n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("case,want", [
    ("bf16_hd128_prefill", "tc"),
    ("bf16_hd64_g2_prefill", "tc"),
    ("bf16_hd128_g8_chunk", "tc"),
    ("bf16_hd16_prefill", "rows"),
    ("bf16_hd32_prefill", "rows"),
    ("bf16_g3_prefill", "rows"),
    ("fp32_hd128_prefill", "rows"),
    ("fp32_decode", "split"),
    ("bf16_decode", "split"),
    ("bf16_g8_decode", "split"),
    ("fp32_sq2_g4", "split"),
    ("bf16_hd16_decode", "rows"),
    ("bf16_misaligned_prefill", "rows"),
])
def test_route(case, want):
    """``route`` decides from dtype, shape and alignment alone, so CPU
    tensors show the choice a CUDA call of the same shapes makes."""
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    B, Sq, Kh, G, hd, Skv = 1, 300, 2, 1, 128, 512
    if "hd64" in case:
        hd = 64
    if "hd16" in case:
        hd = 16
    if "hd32" in case:
        hd = 32
    if "_g2" in case:
        G = 2
    if "_g3" in case:
        G = 3
    if "_g8" in case:
        G = 8
    if "chunk" in case:
        Sq = 16
    if "decode" in case:
        B, Sq = 8, 1
    if "sq2_g4" in case:
        Sq, G = 2, 4
    make = _misaligned if "misaligned" in case else (
        lambda shape, dt: torch.zeros(shape, dtype=dt))
    q = make((B, Sq, Kh, G, hd), dtype)
    k = torch.zeros(B, Skv, Kh, hd, dtype=dtype)
    assert route(q, k, k) == want
