"""The LM training path's backward pieces that the card's kernels
redesign, held on the CPU against the JAX package on the same numpy
inputs:

- the plain forward's per-row log-sum-exp (``flash_attention_ref(...,
  return_lse=True)``, what the kernel's ``rows`` route writes for the
  backward) against ``torch.logsumexp`` of the masked, capped scores;
- ``flash_attention_bwd`` given the forward's output and log-sum-exp (the
  closed form of the kernels' ``saved`` route) against the call without
  them and against ``jax.vjp`` of the reference's ``_block_attention``
  (2e-3, PR 21's tolerance);
- the plain grouped matmul's layout flags against explicit transposes,
  and ``GroupedMatmulFn``'s gradients with each flag against ``jax.vjp``
  of the reference's ``grouped_matmul_ref`` (1e-4);
- ``simt_tile``: the simt kernel's output tile rows, from the shape alone.
The kernels themselves are tested on the card in
``test_torch_kernels_gpu.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_gmm
from repro.models import transformer as jt
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grouped_matmul.ops import (grouped_matmul,
                                                    simt_tile)
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

# (B, Sq, Skv, Kh, G, hd, q_start, kv_len, window, softcap)
ATTN_CASES = {
    "causal": (2, 11, 11, 2, 1, 16, [0, 0], [11, 11], None, None),
    "window_softcap_g2": (2, 13, 13, 1, 2, 16, [0, 0], [13, 13], 4, 3.0),
    "chunk_q_start_g4": (2, 5, 20, 1, 4, 16, [3, 12], [8, 17], None, None),
    "short_kv_len": (2, 9, 16, 2, 2, 16, [0, 0], [9, 6], None, 5.0),
    # batch 1's rows sit at 8.. and see no key below kv_len 3 within the
    # window of 2
    "empty_rows": (2, 6, 10, 1, 2, 16, [0, 8], [6, 3], 2, None),
}


def _attn_inputs(case):
    B, Sq, Skv, Kh, G, hd, qs, kl, window, cap = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, dout = (rng.normal(size=(B, Sq, Kh, G, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, Kh, hd)).astype(np.float32)
            for _ in range(2))
    return (q, k, v, dout, np.array(qs, np.int32), np.array(kl, np.int32),
            window, cap)


def _torch_args(q, k, v, dout, qs, kl):
    return tuple(torch.tensor(a) for a in (q, k, v, dout, qs, kl))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_lse_is_logsumexp_of_the_masked_capped_scores(case):
    q, k, v, _, qs, kl, window, cap = _attn_inputs(case)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    qt, kt, vt, _, st, lt = _torch_args(q, k, v, q, qs, kl)
    out, lse = flash_attention_ref(qt, kt, vt, st, lt, window=window,
                                   softcap=cap, return_lse=True)
    assert lse.shape == (B, Kh, Sq * G) and lse.dtype == torch.float32
    torch.testing.assert_close(out, flash_attention_ref(
        qt, kt, vt, st, lt, window=window, softcap=cap), rtol=0, atol=0)
    s = torch.einsum("bqkgd,bskd->bkqgs", qt, kt) / math.sqrt(hd)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    pos = st[:, None] + torch.arange(Sq)                        # [B, Sq]
    j = torch.arange(Skv)
    mask = (j <= pos[..., None]) & (j < lt[:, None, None])
    if window is not None:
        mask &= j > pos[..., None] - window
    s = s.masked_fill(~mask[:, None, :, None, :], -math.inf)
    want = torch.logsumexp(s, dim=-1).reshape(B, Kh, Sq * G)
    seen = torch.isfinite(want)
    torch.testing.assert_close(lse[seen], want[seen], rtol=1e-6, atol=1e-6)
    assert not lse[~seen].any()
    assert seen.any() and (case != "empty_rows" or not seen.all())


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_saved_route_equals_the_call_without_it(case):
    """On the CPU the saved route is the closed form the kernels compute,
    from the forward's output and log-sum-exp; the call without them is
    autograd through the plain forward.  Rows with no admissible key get
    zero dq, without NaN."""
    q, k, v, dout, qs, kl, window, cap = _attn_inputs(case)
    qt, kt, vt, dt, st, lt = _torch_args(q, k, v, dout, qs, kl)
    kw = {"window": window, "softcap": cap}
    out, lse = flash_attention_ref(qt, kt, vt, st, lt, return_lse=True, **kw)
    got = flash_attention_bwd(qt, kt, vt, dt, st, lt, out=out, lse=lse, **kw)
    want = flash_attention_bwd(qt, kt, vt, dt, st, lt, **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if case == "empty_rows":
        assert not got[0][1].any()


def _attn_cfg(window, cap):
    return jt.TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=64, vocab_size=16,
                                block_q=16, block_kv=16,
                                window=window or 4096, attn_softcap=cap,
                                dtype=jnp.float32)


@pytest.mark.parametrize("case", ["causal", "window_softcap_g2",
                                  "chunk_q_start_g4", "short_kv_len"])
def test_saved_route_matches_jax_vjp(case):
    q, k, v, dout, qs, kl, window, cap = _attn_inputs(case)
    _, vjp = jax.vjp(
        lambda a, b, c: jt._block_attention(
            a, b, c, _attn_cfg(window, cap), jnp.asarray(qs),
            jnp.asarray(kl), is_local=jnp.asarray(window is not None)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt, dt, st, lt = _torch_args(q, k, v, dout, qs, kl)
    kw = {"window": window, "softcap": cap}
    out, lse = flash_attention_ref(qt, kt, vt, st, lt, return_lse=True, **kw)
    got = flash_attention_bwd(qt, kt, vt, dt, st, lt, out=out, lse=lse, **kw)
    for g, r, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{n}")


def _gmm_operands(G, M, K, N, seed=0):
    rng = np.random.default_rng(seed + G * M + K * N)
    return (rng.normal(size=(G, M, K)).astype(np.float32),
            rng.normal(size=(G, K, N)).astype(np.float32),
            rng.normal(size=(G, M, N)).astype(np.float32))


FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("trans_x,trans_w", FLAGS)
def test_plain_layout_flags_equal_explicit_transposes(trans_x, trans_w):
    x, w, _ = _gmm_operands(3, 37, 65, 50)
    xs = np.ascontiguousarray(x.transpose(0, 2, 1)) if trans_x else x
    ws = np.ascontiguousarray(w.transpose(0, 2, 1)) if trans_w else w
    got = grouped_matmul_ref(torch.tensor(xs), torch.tensor(ws),
                             trans_x=trans_x, trans_w=trans_w)
    want = grouped_matmul_ref(torch.tensor(x), torch.tensor(w))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the wrapper takes the same flags on CPU tensors
    torch.testing.assert_close(grouped_matmul(
        torch.tensor(xs), torch.tensor(ws), trans_x=trans_x,
        trans_w=trans_w), want, rtol=0, atol=0)


@pytest.mark.parametrize("trans_x,trans_w", FLAGS)
def test_function_gradients_with_layout_flags_match_jax_vjp(trans_x,
                                                             trans_w):
    """``GroupedMatmulFn``'s dx and dw for operands stored either way (the
    backward's own calls read them in place through the flags) against
    ``jax.vjp`` of the reference's plain grouped matmul of the logical
    operands, each gradient in its operand's stored layout."""
    x, w, dy = _gmm_operands(4, 40, 24, 16)
    _, vjp = jax.vjp(jax_gmm, jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    xs = np.ascontiguousarray(x.transpose(0, 2, 1)) if trans_x else x
    ws = np.ascontiguousarray(w.transpose(0, 2, 1)) if trans_w else w
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (xs, ws))
    out = grouped_matmul(xt, wt, trans_x=trans_x, trans_w=trans_w)
    gx, gw = torch.autograd.grad(out, (xt, wt), torch.tensor(dy))
    assert gx.shape == xt.shape and gw.shape == wt.shape
    np.testing.assert_allclose(
        gx.numpy(), want_x.transpose(0, 2, 1) if trans_x else want_x,
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        gw.numpy(), want_w.transpose(0, 2, 1) if trans_w else want_w,
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("G,M,N,want", [
    (8, 5120, 512, 128), (8, 5120, 256, 128),     # lm-moe: forward, dx
    (8, 256, 512, 64), (8, 512, 256, 64),         # lm-moe: dw, 64 tiles
    (64, 8, 1024, 64),                            # decode: M <= 64
    (64, 311, 2048, 128),                         # prefill: 768 tiles
    (2, 33, 17, 64), (3, 130, 200, 64),           # ragged, few tiles
    (1, 65, 16_768, 64), (1, 65, 16_769, 128),    # 131 and 132 tiles
])
def test_simt_tile_follows_the_shape(G, M, N, want):
    """128-row tiles where they number at least the H100's 132 SMs and M >
    64, else 64-row tiles; nothing but the shape decides."""
    assert simt_tile(G, M, N) == want == simt_tile(G, M, N)
