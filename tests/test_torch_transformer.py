"""The port's LM family (``repro_torch.models.transformer``) held against
the reference model on the same weights (``params_from_reference``), for
each of the five SMOKE configs in float32: ``forward`` logits and the MoE
aux loss, ``prefill`` + ``decode_step`` and the caches they write, and
``decode_step_multi`` with per-slot positions.  Tolerance rtol 2e-3 /
atol 2e-4, as the reference's ``test_prefill_decode_parity``."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models.common import count_params as jax_count_params
from repro_torch.models import transformer as pt
from repro_torch.models.common import count_params

CONFIGS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "qwen2_5_32b",
           "phi3_medium_14b", "gemma2_27b"]
RTOL, ATOL = 2e-3, 2e-4


def _configs(name, which="SMOKE"):
    ref = getattr(importlib.import_module(f"repro.configs.{name}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                   which)
    return ref, port


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    """(reference cfg, its params, port cfg, port model) in float32."""
    ref, port = _configs(request.param)
    jc = dataclasses.replace(ref, dtype=jnp.float32)
    pc = dataclasses.replace(port, dtype=torch.float32)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    model = pt.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jc, params, pc, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_configs_and_analytics_match_reference(name, which):
    ref, port = _configs(name, which)
    r, p = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert r.pop("dtype") == jnp.bfloat16 and p.pop("dtype") == torch.bfloat16
    assert r == p
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.decode_flops(8, 4096) == ref.decode_flops(8, 4096)
    assert port.is_local_flags() == list(np.asarray(ref.is_local_flags()))


def test_count_params(pair):
    jc, params, pc, model = pair
    bias = (pc.n_layers * (pc.n_heads + 2 * pc.n_kv_heads) * pc.hd
            if pc.qkv_bias else 0)    # param_count leaves the biases out
    assert count_params(model) == jax_count_params(params)
    assert count_params(model) == pc.param_count() + bias


def test_forward_matches_reference(pair):
    jc, params, pc, model = pair
    toks = np.random.default_rng(1).integers(0, pc.vocab_size, (2, 24))
    lj, _, aj = jt.forward(params, jnp.asarray(toks, jnp.int32), jc)
    lp, caches, ap = pt.forward(model, torch.as_tensor(toks), pc)
    assert caches is None and lp.shape == (2, 24, pc.vocab_size)
    _close(lp, lj)
    _close(ap, aj)
    if pc.moe:
        assert float(ap) > 0


def test_prefill_decode_matches_reference(pair):
    jc, params, pc, model = pair
    toks = np.random.default_rng(2).integers(0, pc.vocab_size, (2, 12))
    cj = jt.init_kv_cache(jc, 2, 24)
    cp = pt.init_kv_cache(pc, 2, 24, device="cpu")
    lj, cj = jt.prefill(params, jnp.asarray(toks[:, :8], jnp.int32), jc, cj)
    lp, cp = pt.prefill(model, torch.as_tensor(toks[:, :8]), pc, cp)
    _close(lp, lj)
    lj, cj = jt.decode_step(params, jnp.asarray(toks[:, 8:9], jnp.int32), jc,
                            cj, jnp.int32(8))
    lp, cp = pt.decode_step(model, torch.as_tensor(toks[:, 8:9]), pc, cp, 8)
    _close(lp, lj)
    for n in ("k", "v"):
        _close(cp[n], cj[n])
    # and the cached path equals a plain forward over the 9 tokens
    full, _, _ = pt.forward(model, torch.as_tensor(toks[:, :9]), pc)
    _close(lp, full[:, -1])


def test_decode_step_multi_matches_reference(pair):
    """Slots at different positions over a cache whose rows past each
    slot's position hold stale values."""
    jc, params, pc, model = pair
    rng = np.random.default_rng(3)
    shape = (pc.n_layers, 3, 20, pc.n_kv_heads, pc.hd)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    toks = rng.integers(0, pc.vocab_size, (3, 1))
    pos = np.array([4, 17, 0], np.int32)
    lj, cj = jt.decode_step_multi(
        params, jnp.asarray(toks, jnp.int32), jc,
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(pos))
    lp, cp = pt.decode_step_multi(
        model, torch.as_tensor(toks), pc,
        {"k": torch.tensor(ck), "v": torch.tensor(cv)}, torch.tensor(pos))
    _close(lp, lj)
    for n in ("k", "v"):
        _close(cp[n], cj[n])


@pytest.fixture(scope="module")
def olmoe_bf16():
    """OLMoE's SMOKE config as it serves (bf16), the reference's weights
    and a 64-token batch of 2."""
    ref, port = _configs("olmoe_1b_7b")
    params = jt.init_params(ref, jax.random.PRNGKey(0))
    model = pt.params_from_reference(port, jax.tree.map(np.asarray, params),
                                     device="cpu")
    toks = np.random.default_rng(0).integers(0, 256, (2, 64)).astype(
        np.int32)
    return ref, params, port, model, toks


@pytest.mark.parametrize("entry", ["prefill", "decode_step",
                                   "decode_step_multi"])
def test_last_logits_hold_only_their_own_rows(entry, olmoe_bf16):
    """The three entry points return the last position's logits as a
    tensor of its own, as the reference does: its storage holds exactly
    the reference's ``[B, V]`` bytes (1,024 here), not the whole ``[B, S,
    V]`` logits a view of their last row would keep alive (65,536 for the
    64-token prefill)."""
    ref, params, port, model, toks = olmoe_bf16
    B, S = toks.shape
    cj = jt.init_kv_cache(ref, B, S + 1)
    cp = pt.init_kv_cache(port, B, S + 1, device="cpu")
    if entry == "prefill":
        want, _ = jt.prefill(params, jnp.asarray(toks), ref, cj)
        got, _ = pt.prefill(model, torch.as_tensor(toks), port, cp)
    elif entry == "decode_step":
        want, _ = jt.decode_step(params, jnp.asarray(toks[:, :1]), ref, cj,
                                 jnp.int32(S))
        got, _ = pt.decode_step(model, torch.as_tensor(toks[:, :1]), port,
                                cp, S)
    else:
        pos = np.array([3, S], np.int32)
        want, _ = jt.decode_step_multi(params, jnp.asarray(toks[:, :1]), ref,
                                       cj, jnp.asarray(pos))
        got, _ = pt.decode_step_multi(model, torch.as_tensor(toks[:, :1]),
                                      port, cp, torch.as_tensor(pos))
    want = np.asarray(want)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (
        B, port.vocab_size)
    assert got.untyped_storage().nbytes() == want.nbytes == 1024
    assert got.is_contiguous()


_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=61, block_q=8, block_kv=8)


def test_cache_write_past_the_end_clamps_its_start_as_the_reference():
    """8 tokens at ``cache_index=10`` into a 16-row cache: the reference's
    ``dynamic_update_slice`` writes rows 8-15 (its start clamps to
    Smax - S) while the queries keep positions 10-17; the port the same."""
    jc = jt.TransformerConfig(**_TINY, dtype=jnp.float32)
    pc = pt.TransformerConfig(**_TINY, dtype=torch.float32)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    model = pt.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 61, (1, 8))
    cj = jt.init_kv_cache(jc, 1, 16)
    cp = pt.init_kv_cache(pc, 1, 16, device="cpu")
    lj, cj, _ = jt.forward(params, jnp.asarray(toks, jnp.int32), jc,
                           kv_caches=cj, cache_index=10)
    lp, cp, _ = pt.forward(model, torch.as_tensor(toks), pc, kv_caches=cp,
                           cache_index=10)
    assert lp.shape == (1, 8, 61) and bool(torch.isfinite(lp).all())
    _close(lp, lj)
    for n in ("k", "v"):
        assert np.asarray(cj[n])[:, :, 8:].any()
        _close(cp[n][:, :, 8:], np.asarray(cj[n])[:, :, 8:])
        _close(cp[n], cj[n])


def test_init_params_laws_and_seed():
    _, cfg = _configs("olmoe_1b_7b")
    a = pt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = pt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert count_params(a) == cfg.param_count()
    assert not any(p.requires_grad for p in a.parameters())
    lay = a.layers[0]
    assert a.embed.dtype == lay.attn.wq.dtype == lay.mlp.w1.dtype == \
        torch.bfloat16
    assert lay.mlp.router.dtype == lay.ln1.dtype == a.final_norm.dtype == \
        torch.float32
    assert torch.equal(lay.ln1, torch.ones_like(lay.ln1))
    # truncated at +-2 standard deviations of 1/sqrt(fan_in)
    w1 = lay.mlp.w1.float()
    assert float(w1.abs().max()) <= 2 / cfg.d_model ** 0.5 * 1.01
    assert 0.8 < float(w1.std()) * cfg.d_model ** 0.5 < 0.95


def test_entry_points_refuse_numerics_they_do_not_port():
    _, cfg = _configs("phi3_medium_14b")
    with pytest.raises(NotImplementedError, match="attn_p_bf16"):
        pt.init_params(dataclasses.replace(cfg, attn_p_bf16=True),
                       torch.Generator(), device="cpu")


def test_entry_points_without_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _configs("olmoe_1b_7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.init_kv_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.params_from_reference(cfg, {})
