"""Shared model building blocks, the port of ``src/repro/models/common.py``.

Same dtype flow as the reference: norms and rotary embeddings compute in
fp32 and cast back to the input's dtype.  Random draws take an explicit
``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """``None`` means cuda; cuda without a card raises (no CPU fallback).
    A cuda device comes back with its index (``cuda`` -> ``cuda:<current>``),
    as tensors report theirs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the model runs on cuda, and no CUDA device is available; "
                "pass device='cpu' to run the plain CPU versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dense_init_(t: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """``dense_init``'s law drawn into ``t`` in place (a float32 tensor on
    the generator's device): truncated normal at +-2, times ``scale``
    (default 1/sqrt(fan-in))."""
    shape = t.shape
    fan_in = shape[0] if len(shape) == 2 else (
        shape[-2] if len(shape) >= 2 else shape[0])
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def dense_init(shape, generator: torch.Generator, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (at +-2) fan-in init, drawn in fp32 on ``device``
    (the generator's device) and cast to ``dtype``.  Scaled in place and
    cast only to another dtype, so a float32 draw holds one copy."""
    t = dense_init_(torch.empty(shape, dtype=torch.float32, device=device),
                    generator, scale)
    return t if dtype == torch.float32 else t.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    g = (1.0 + scale) if zero_centered else scale
    return (y * g).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions ``[*shape]`` -> (sin, cos) with trailing dim head_dim//2."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x ``[..., seq, heads, head_dim]``; sin/cos ``[..., seq, head_dim//2]``."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE. logits ``[..., V]`` (any dtype, summed in fp32),
    labels int ``[...]``; with ``mask``, the mean over its weights."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
