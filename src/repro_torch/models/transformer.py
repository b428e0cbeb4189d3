"""Decoder-only transformer LM family, the port of
``src/repro/models/transformer.py``.

One configurable implementation covers the five LM architectures: dense
(qwen2.5-32b, phi3-medium) and MoE (olmoe-1b-7b, moonshot-16b-a3b) MLPs,
GQA with optional QKV bias, RoPE, and gemma2-27b's extras (alternating
local/global attention, attention and final logit softcaps, pre+post
RMSNorm, zero-centred norm scales).

Attention runs through the hand-written FlashAttention kernel
(``kernels/flash_attention``) and the MoE expert FFN's three grouped
products through the grouped-matmul kernel (``kernels/grouped_matmul``);
the q/k/v/o projections, the router and the LM head stay ``torch.matmul``,
as the reference left them to XLA.  Layers run in a Python loop (the
reference's ``lax.scan``).  The KV cache is updated in place.

Parameters live in ``nn.Module``s that mirror the reference's tree
(``params_from_reference`` copies one over, ``params_to_reference`` copies
back).  A model built with ``master=True`` (for training) holds every
parameter in fp32, as the reference's ``init_params`` does: the forward
casts each to ``cfg.dtype`` where it is used (the reference's casts), so a
bf16 config computes in bf16 and its gradients arrive in fp32 through the
casts.  A model built for serving (the default) keeps the matmul weights,
the embedding and the head in ``cfg.dtype`` and the router and the norm
scales in fp32, the port's deliberate divergence: half the weight bytes,
and the casts cost nothing.  Either way top-k routing sees the same fp32
logits.  Parameters are made without ``requires_grad``;
``make_train_step`` turns it on for the parameters it trains, and refuses
a model that is not all fp32.  Training runs each layer under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``)
and differentiates through both kernels' ``autograd.Function``s.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.common import (apply_rope, cross_entropy,
                                       dense_init, dense_init_,
                                       resolve_device, rms_norm, rope_angles,
                                       softcap)
from repro_torch.models.sharding import shard_hint


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # gemma2 extras
    layer_pattern: str = "global"      # "global" | "local_global"
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False
    zero_centered_norm: bool = False
    # compute
    dtype: torch.dtype = torch.bfloat16
    block_q: int = 512
    block_kv: int = 1024
    remat: bool = True
    # the reference's perf knobs: the first two leave results unchanged
    # and are ignored here; attn_p_bf16 changes numerics and is refused
    causal_block_skip: bool = False
    attn_remat: bool = False
    attn_p_bf16: bool = False
    aux_loss_weight: float = 0.01

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_local_flags(self) -> list[bool]:
        """Per layer: sliding-window layer?  gemma2 alternates
        local (even) / global (odd)."""
        local = self.layer_pattern == "local_global"
        return [local and i % 2 == 0 for i in range(self.n_layers)]

    # ------------------------------------------------------------- analytics
    def param_count(self) -> int:
        D, H, K, hd, F_, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.hd, self.d_ff, self.vocab_size,
                                 self.n_layers)
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.moe:
            mlp = self.n_experts * 3 * D * F_ + D * self.n_experts
        else:
            mlp = 3 * D * F_
        norms = (4 if self.post_norms else 2) * D
        return L * (attn + mlp + norms) + 2 * V * D + D

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        D, F_, L = self.d_model, self.d_ff, self.n_layers
        dead = L * (self.n_experts - self.top_k) * 3 * D * F_
        return self.param_count() - dead

    def train_flops(self, batch: int, seq: int) -> float:
        """6*N_active*D model flops (the reference's MODEL_FLOPS
        convention)."""
        return 6.0 * self.active_param_count() * batch * seq

    def decode_flops(self, batch: int, kv_len: int) -> float:
        """Per decode token: 2*N_active + attention reads."""
        attn = (4.0 * self.n_layers * self.n_kv_heads * self.hd * kv_len
                * (self.n_heads // self.n_kv_heads))
        return batch * (2.0 * self.active_param_count() + attn)


# ============================================================== modules


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, dt: torch.dtype):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param((D, H * hd), dt, device)
        self.wk = _param((D, K * hd), dt, device)
        self.wv = _param((D, K * hd), dt, device)
        self.wo = _param((H * hd, D), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((H * hd,), dt, device)
            self.bk = _param((K * hd,), dt, device)
            self.bv = _param((K * hd,), dt, device)


class MLP(nn.Module):
    """Dense SwiGLU (w1, w3 ``[D, F]``, w2 ``[F, D]``) or, for MoE, an fp32
    router ``[D, E]`` and stacked experts (w1, w3 ``[E, D, F]``, w2
    ``[E, F, D]``), the experts in ``dt``."""

    def __init__(self, cfg: TransformerConfig, device, dt: torch.dtype):
        super().__init__()
        D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        if cfg.moe:
            self.router = _param((D, E), torch.float32, device)
            self.w1 = _param((E, D, F_), dt, device)
            self.w3 = _param((E, D, F_), dt, device)
            self.w2 = _param((E, F_, D), dt, device)
        else:
            self.w1 = _param((D, F_), dt, device)
            self.w3 = _param((D, F_), dt, device)
            self.w2 = _param((F_, D), dt, device)


class Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, dt: torch.dtype):
        super().__init__()
        D = cfg.d_model
        self.attn = Attention(cfg, device, dt)
        self.mlp = MLP(cfg, device, dt)
        self.ln1 = _param((D,), torch.float32, device)
        self.ln2 = _param((D,), torch.float32, device)
        if cfg.post_norms:
            self.ln1_post = _param((D,), torch.float32, device)
            self.ln2_post = _param((D,), torch.float32, device)


class Transformer(nn.Module):
    """The parameter tree (uninitialised: ``init_params`` or
    ``params_from_reference`` fill it); ``forward`` runs it.  With
    ``master`` every parameter is fp32 (training); without, the matmul
    weights, embedding and head are in ``cfg.dtype`` (serving)."""

    def __init__(self, cfg: TransformerConfig, device, master: bool = False):
        super().__init__()
        if cfg.attn_p_bf16:
            raise NotImplementedError(
                "attn_p_bf16 (bf16 attention probabilities) changes the "
                "numerics and is not supported by the port")
        D, V = cfg.d_model, cfg.vocab_size
        dt = torch.float32 if master else cfg.dtype
        self.embed = _param((V, D), dt, device)
        self.head = _param((D, V), dt, device)
        self.final_norm = _param((D,), torch.float32, device)
        self.layers = nn.ModuleList(Layer(cfg, device, dt)
                                    for _ in range(cfg.n_layers))

    def reference_tree(self) -> dict:
        """The parameters in the reference's tree: ``embed``, ``head``,
        ``final_norm``, and under ``layers`` each leaf as the list of its
        per-layer parameters (the reference stacks them on a leading
        ``L`` axis)."""
        def per_layer(get):
            first = get(self.layers[0])
            return {n: [get(layer)[n] for layer in self.layers]
                    for n in first}

        def own(module):
            return dict(module.named_parameters(recurse=False))

        return {"embed": self.embed, "head": self.head,
                "final_norm": self.final_norm,
                "layers": {"attn": per_layer(lambda m: own(m.attn)),
                           "mlp": per_layer(lambda m: own(m.mlp)),
                           **per_layer(own)}}


# ============================================================== init


@torch.no_grad()
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None, master: bool = False) -> Transformer:
    """Random weights drawn from ``generator`` (on ``device``), with the
    reference's init laws: truncated-normal fan-in matmul weights (experts
    at 1/sqrt(fan-in) of their own input), zero biases, unit norm scales
    (zero where zero-centred).  ``device=None`` means cuda; ``master`` as
    ``Transformer``'s (the same draws, kept in fp32)."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, master=master)

    def draw(p, scale=None):
        if p.dtype == torch.float32:    # drawn in place: no second copy
            dense_init_(p, generator, scale)
        else:
            p.copy_(dense_init(p.shape, generator, scale, device=dev))

    norm = 0.0 if cfg.zero_centered_norm else 1.0
    draw(model.embed, 1.0)
    draw(model.head)
    model.final_norm.fill_(norm)
    for layer in model.layers:
        a, m = layer.attn, layer.mlp
        for w in (a.wq, a.wk, a.wv, a.wo):
            draw(w)
        if cfg.qkv_bias:
            for b in (a.bq, a.bk, a.bv):
                b.zero_()
        if cfg.moe:
            draw(m.router)
        # fan-in scale: an expert's is its own input (d_model, d_ff)
        for w in (m.w1, m.w3, m.w2):
            draw(w)
        layer.ln1.fill_(norm)
        layer.ln2.fill_(norm)
        if cfg.post_norms:
            layer.ln1_post.zero_()
            layer.ln2_post.zero_()
    return model


@torch.no_grad()
def params_from_reference(cfg: TransformerConfig, arrays: dict,
                          device=None, master: bool = False) -> Transformer:
    """The reference's parameter tree (``embed``, ``head``, ``final_norm``
    and ``layers`` with ``[L, ...]``-stacked leaves, as numpy arrays) as
    the port's modules on ``device`` (``None`` means cuda); ``master`` as
    ``Transformer``'s (with it, the reference's fp32 leaves as they are)."""
    model = Transformer(cfg, resolve_device(device), master=master)

    def put(p, a):
        p.copy_(torch.tensor(np.asarray(a, dtype=np.float32)))

    def put_all(module, tree, i):
        names = {n for n, _ in module.named_parameters(recurse=False)}
        if names != set(tree):
            raise ValueError(f"parameter names differ: port {sorted(names)}"
                             f", reference {sorted(tree)}")
        for n, p in module.named_parameters(recurse=False):
            put(p, tree[n][i])

    for n in ("embed", "head", "final_norm"):
        put(getattr(model, n), arrays[n])
    lay = arrays["layers"]
    norms = {n: v for n, v in lay.items() if n.startswith("ln")}
    for i, layer in enumerate(model.layers):
        put_all(layer.attn, lay["attn"], i)
        put_all(layer.mlp, lay["mlp"], i)
        put_all(layer, norms, i)
    return model


@torch.no_grad()
def params_to_reference(model: Transformer, cfg: TransformerConfig) -> dict:
    """The inverse of ``params_from_reference``: the model's parameters as
    the reference's tree of float32 numpy arrays, each layer leaf stacked
    on a leading ``L`` axis."""
    if len(model.layers) != cfg.n_layers:
        raise ValueError(f"the model has {len(model.layers)} layers, the "
                         f"config {cfg.n_layers}")

    def host(x):
        if isinstance(x, list):
            return np.stack([host(t) for t in x])
        if isinstance(x, dict):
            return {n: host(t) for n, t in x.items()}
        return x.detach().float().cpu().numpy()

    return host(model.reference_tree())


# ============================================================== attention


def attention(x, ap: Attention, cfg: TransformerConfig, positions, is_local,
              kv_cache=None, cache_index=None):
    """Self-attention sublayer.  With a cache (``kv_cache`` = the layer's
    ``(k, v)``, ``[B, Smax, Kh, hd]``) the step's k/v are written into it in
    place at ``cache_index`` (an int: rows ``t .. t+S``; a ``[B]`` tensor:
    one row per slot, ``S == 1``) and attention runs over the cache."""
    B, S, _ = x.shape
    Kh, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    q = x @ ap.wq.to(dt)
    k = x @ ap.wk.to(dt)
    v = x @ ap.wv.to(dt)
    if cfg.qkv_bias:
        q = q + ap.bq.to(dt)
        k = k + ap.bk.to(dt)
        v = v + ap.bv.to(dt)
    q = shard_hint(q.reshape(B, S, Kh, G, hd), "act_q")
    k = shard_hint(k.reshape(B, S, Kh, hd), "act_kv")
    v = shard_hint(v.reshape(B, S, Kh, hd), "act_kv")
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, S, Kh * G, hd), sin, cos).reshape(
        B, S, Kh, G, hd)
    k = apply_rope(k, sin, cos)
    window = cfg.window if is_local else None

    if kv_cache is None:
        out = flash_attention(q, k, v, 0, S, window=window,
                              softcap=cfg.attn_softcap)
    else:
        ck, cv = kv_cache
        t = cache_index
        if isinstance(t, torch.Tensor) and t.dim() == 1:
            if S != 1:
                raise ValueError("per-slot cache positions need S == 1")
            # a slot at t >= Smax writes nothing, as JAX's ``.at[].set``
            # drops an out-of-range update: the index is clamped and the
            # row keeps its old value there, with no read on the host
            rows = torch.arange(B, device=x.device)
            Smax = ck.shape[1]
            idx = t.long().clamp(max=Smax - 1)
            keep = (t < Smax)[:, None, None]
            ck[rows, idx] = torch.where(keep, k[:, 0].to(ck.dtype),
                                        ck[rows, idx])
            cv[rows, idx] = torch.where(keep, v[:, 0].to(cv.dtype),
                                        cv[rows, idx])
        else:
            t = int(t)
            # the write's start clamps to [0, Smax - S], as
            # ``jax.lax.dynamic_update_slice`` does; q_start and kv_len
            # stay t and t + S
            t0 = max(0, min(t, ck.shape[1] - S))
            ck[:, t0:t0 + S] = k.to(ck.dtype)
            cv[:, t0:t0 + S] = v.to(cv.dtype)
        out = flash_attention(q, ck, cv, t, t + S, window=window,
                              softcap=cfg.attn_softcap)
    return out.reshape(B, S, Kh * G * hd) @ ap.wo.to(dt)


# ====================================================== MLP / MoE


def dense_mlp(x, mp: MLP, cfg: TransformerConfig):
    dt = cfg.dtype
    h = F.silu(x @ mp.w1.to(dt)) * (x @ mp.w3.to(dt))
    h = shard_hint(h, "act_ff")
    return h @ mp.w2.to(dt)


def moe_mlp(x, mp: MLP, cfg: TransformerConfig):
    """Top-k token-choice MoE with static capacity (sort-based dispatch,
    slot-indexed buffers).  Returns (out, aux_loss)."""
    B, S, D = x.shape
    dt = cfg.dtype
    dev = x.device
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = max(int(cfg.capacity_factor * T * k / E), 8)
    xf = x.reshape(T, D)

    logits = xf.float() @ mp.router.float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    topw, topi = torch.topk(probs, k, dim=-1)                    # [T, k]
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch): E * sum_e mean_prob_e * mean_assign_e
    assign = torch.zeros((T, E), dtype=torch.float32, device=dev).scatter_(
        1, topi, 1.0)
    aux = E * torch.sum(probs.mean(0) * assign.mean(0))

    flat_e = topi.reshape(-1)                                    # [T*k]
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = topw.reshape(-1)
    # stable, as jnp.argsort: capacity keeps the earliest tokens
    order = torch.argsort(flat_e, stable=True)
    se, stok, sw = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))  # [E]
    rank = torch.arange(T * k, device=dev) - starts[se]
    keep = rank < C
    dest = torch.where(keep, se * C + rank, E * C)               # E*C = drop

    # slot -> token / weight maps over [E*C] slots, the sentinel sliced off
    slot_token = torch.zeros(E * C + 1, dtype=torch.int64,
                             device=dev).index_put_((dest,), stok)[:-1]
    slot_w = torch.zeros(E * C + 1, dtype=torch.float32,
                         device=dev).index_put_((dest,), sw * keep)[:-1]
    slot_valid = (slot_w > 0).to(dt)

    # index_select, whose backward is an index_add_: advanced indexing's
    # sorts the indices, and every empty slot points at token 0
    buf = (xf.index_select(0, slot_token).to(dt)
           * slot_valid[:, None]).reshape(E, C, D)
    buf = shard_hint(buf, "moe_buf")
    w1, w3, w2 = mp.w1.to(dt), mp.w3.to(dt), mp.w2.to(dt)
    h = F.silu(grouped_matmul(buf, w1)) * grouped_matmul(buf, w3)
    h = shard_hint(h, "moe_ff")
    eout = grouped_matmul(h, w2).reshape(E * C, D)
    eout = eout * slot_w.to(dt)[:, None]
    eout = shard_hint(eout, "moe_eout")

    out = torch.zeros((T, D), dtype=dt, device=dev).index_add_(
        0, slot_token, eout * slot_valid[:, None])
    out = shard_hint(out, "moe_rows")
    return out.reshape(B, S, D), aux


# ====================================================== forward


def _layer(x, layer: Layer, cfg: TransformerConfig, positions, is_local,
           kv_cache=None, cache_index=None):
    zc = cfg.zero_centered_norm
    h = rms_norm(x, layer.ln1.float(), zero_centered=zc)
    o = attention(h, layer.attn, cfg, positions, is_local, kv_cache,
                  cache_index)
    if cfg.post_norms:
        o = rms_norm(o, layer.ln1_post.float(), zero_centered=zc)
    x = x + o
    h = rms_norm(x, layer.ln2.float(), zero_centered=zc)
    if cfg.moe:
        f, aux = moe_mlp(h, layer.mlp, cfg)
    else:
        f = dense_mlp(h, layer.mlp, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_norms:
        f = rms_norm(f, layer.ln2_post.float(), zero_centered=zc)
    return shard_hint(x + f, "act_resid"), aux


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig, kv_caches=None, cache_index=None):
    """tokens ``[B, S]`` -> (logits ``[B, S, V]``, kv_caches or None, aux).

    kv_caches: optional ``{"k": [L, B, Smax, Kh, hd], "v": ...}``; when
    given, the step writes at ``cache_index`` (in place) and attends over
    the cache (prefill/decode), and the same dict is returned."""
    B, S = tokens.shape
    dt = cfg.dtype
    dev = tokens.device
    x = F.embedding(tokens, params.embed.to(dt))
    if cfg.name.startswith("gemma"):
        # the reference rounds the scale to the compute dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    x = shard_hint(x, "act_resid")
    steps = torch.arange(S, device=dev)[None]
    if cache_index is None:
        positions = steps.expand(B, S)
    elif isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        positions = cache_index[:, None].to(dev) + steps
    else:
        positions = (int(cache_index) + steps).expand(B, S)
    flags = cfg.is_local_flags()
    # the reference's jax.checkpoint of each layer: the backward recomputes
    # a layer's activations (and launches its kernels again)
    remat = kv_caches is None and cfg.remat and torch.is_grad_enabled()
    auxs = []
    for i, layer in enumerate(params.layers):
        if remat:
            x, aux = checkpoint(_layer, x, layer, cfg, positions, flags[i],
                                use_reentrant=False)
        else:
            kv = (None if kv_caches is None
                  else (kv_caches["k"][i], kv_caches["v"][i]))
            x, aux = _layer(x, layer, cfg, positions, flags[i], kv,
                            cache_index)
        auxs.append(aux)
    x = rms_norm(x, params.final_norm.float(),
                 zero_centered=cfg.zero_centered_norm)
    logits = softcap(x @ params.head.to(dt), cfg.final_softcap)
    logits = shard_hint(logits, "logits")
    return logits, kv_caches, torch.stack(auxs).mean()


# ====================================================== entry points


def loss_fn(model: Transformer, batch: dict, cfg: TransformerConfig):
    """Next-token CE over ``batch["tokens"] [B, S]`` plus the weighted MoE
    aux loss; returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, _, aux = forward(model, tokens, cfg)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss + cfg.aux_loss_weight * aux, {"ce": loss, "aux": aux}


def make_train_step(cfg: TransformerConfig, adam_cfg):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``repro_torch.train.step``'s step over ``loss_fn``, one
    int8 scale a stacked layer leaf under compression.  Any config: the
    model must hold fp32 parameters (``master=True`` for a config that
    computes in another dtype), which the forward casts to ``cfg.dtype``
    and AdamW updates in fp32, as the reference's masters; a model that
    does not raises ``ValueError`` (nothing is cast behind the caller)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step as train_step
    step = train_step(loss_fn, cfg, adam_cfg, groups=opt.stacked_leaves)

    def train_step_on_masters(model, opt_state, batch):
        low = sorted({str(p.dtype) for p in model.parameters()
                      if p.dtype != torch.float32})
        if low:
            raise ValueError(
                f"make_train_step: {cfg.name} trains fp32 master parameters"
                f", and this model holds {', '.join(low)} ones; build the "
                "model with masters (master=True)")
        return step(model, opt_state, batch)

    return train_step_on_masters


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None) -> dict:
    """Zeroed ``{"k", "v"}`` caches ``[L, batch, max_len, Kh, hd]`` in
    ``cfg.dtype`` on ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def prefill(params, tokens, cfg: TransformerConfig, kv_caches):
    """Process the prompt, filling the cache.  Returns (last_logits,
    caches); the last logits ``[B, V]`` are a tensor of their own, as the
    reference's, so the step's ``[B, S, V]`` logits are freed."""
    logits, caches, _ = forward(params, tokens, cfg, kv_caches,
                                cache_index=0)
    return logits[:, -1].clone(), caches


def decode_step(params, tokens, cfg: TransformerConfig, kv_caches, t):
    """One decode step: tokens ``[B, 1]`` at position ``t``.  Returns
    (logits ``[B, V]``, caches)."""
    logits, caches, _ = forward(params, tokens, cfg, kv_caches,
                                cache_index=t)
    return logits[:, -1].clone(), caches


def decode_step_multi(params, tokens, cfg: TransformerConfig, kv_caches,
                      pos):
    """Continuous-batching decode: tokens ``[B, 1]`` with per-slot
    positions ``pos [B]`` (each slot at a different point in its
    sequence)."""
    logits, caches, _ = forward(params, tokens, cfg, kv_caches,
                                cache_index=pos)
    return logits[:, -1].clone(), caches
