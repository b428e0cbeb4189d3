"""Plain PyTorch version of the model's attention (the function the CUDA
kernel in ``csrc/flash_attention.cu`` computes).

It is the reference model's ``_block_attention``
(``src/repro/models/transformer.py``) in one pass: grouped queries over a
KV-cache layout, per-batch query offsets and valid lengths, an optional
sliding window and logit softcap, fp32 math.  The reference's Pallas
kernel computes the special case ``q_start = 0``, ``kv_len = Skv``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def per_batch(value, batch: int, device) -> torch.Tensor:
    """An int or a ``[batch]`` tensor as a ``[batch]`` int32 tensor."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).reshape(
            -1).expand(batch)
    return torch.full((batch,), int(value), dtype=torch.int32,
                      device=device)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start, kv_len, *, window: int | None = None,
                        softcap: float | None = None) -> torch.Tensor:
    """q ``[B, Sq, Kh, G, hd]``; k, v ``[B, Skv, Kh, hd]``; ``q_start`` and
    ``kv_len`` ints or ``[B]`` tensors.  Query ``i`` of batch ``b`` sits at
    position ``q_start[b] + i`` and may attend to key position ``j`` when
    ``j <= pos``, ``j > pos - window`` and ``j < kv_len[b]``; the mask
    applies after the softcap.  Returns ``[B, Sq, Kh, G, hd]`` in q.dtype.
    A query with no admissible key gets zeros (the model never makes one:
    every query may see itself)."""
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    q_pos = per_batch(q_start, B, dev)[:, None] + torch.arange(
        Sq, device=dev, dtype=torch.int32)                      # [B, Sq]
    kv_pos = torch.arange(Skv, device=dev, dtype=torch.int32)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]           # [B, Sq, Skv]
    if window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    mask &= kv_pos[None, None, :] < per_batch(kv_len, B, dev)[:, None, None]
    mask = mask[:, None, None]                                  # [B,1,1,Sq,Skv]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, q_start,
                            kv_len, *, window: int | None = None,
                            softcap: float | None = None):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention_ref`` at
    (q, k, v) for the output gradient ``dout``: autograd through the plain
    forward, recomputed here.  A query with no admissible key gets zero
    gradients (its output is the constant 0)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_ref(*leaves, q_start, kv_len, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, leaves, dout)
