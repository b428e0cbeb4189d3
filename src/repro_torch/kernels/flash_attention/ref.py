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


def admissible_pairs(B: int, Sq: int, Skv: int, q_start, kv_len,
                     window=None) -> int:
    """The (query, key) pairs ``_mask`` admits, summed over the batch, for
    int ``q_start`` and ``kv_len``; where either is a tensor (which may
    lie on the meta device, so it is not read) every pair of the ``Sq x
    Skv`` block counts."""
    if isinstance(q_start, torch.Tensor) or isinstance(kv_len, torch.Tensor):
        return B * Sq * Skv
    pos = torch.arange(Sq, dtype=torch.int64) + int(q_start)
    hi = torch.clamp(pos, max=min(int(kv_len), Skv) - 1)
    lo = (torch.zeros_like(pos) if window is None
          else torch.clamp(pos - int(window) + 1, min=0))
    return B * int(torch.clamp(hi - lo + 1, min=0).sum())


def _mask(q_start, kv_len, B: int, Sq: int, Skv: int, window, dev):
    """``[B, 1, 1, Sq, Skv]``: may query ``i`` of batch ``b`` (at position
    ``q_start[b] + i``) attend to key ``j``."""
    q_pos = per_batch(q_start, B, dev)[:, None] + torch.arange(
        Sq, device=dev, dtype=torch.int32)                      # [B, Sq]
    kv_pos = torch.arange(Skv, device=dev, dtype=torch.int32)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]           # [B, Sq, Skv]
    if window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    mask &= kv_pos[None, None, :] < per_batch(kv_len, B, dev)[:, None, None]
    return mask[:, None, None]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start, kv_len, *, window: int | None = None,
                        softcap: float | None = None,
                        return_lse: bool = False):
    """q ``[B, Sq, Kh, G, hd]``; k, v ``[B, Skv, Kh, hd]``; ``q_start`` and
    ``kv_len`` ints or ``[B]`` tensors.  Query ``i`` of batch ``b`` sits at
    position ``q_start[b] + i`` and may attend to key position ``j`` when
    ``j <= pos``, ``j > pos - window`` and ``j < kv_len[b]``; the mask
    applies after the softcap.  Returns ``[B, Sq, Kh, G, hd]`` in q.dtype.
    A query with no admissible key gets zeros (the model never makes one:
    every query may see itself).  With ``return_lse`` it returns ``(out,
    lse)``: each row's log-sum-exp of its capped, admissible scores, fp32
    ``[B, Kh, Sq * G]`` (row ``sq * G + g``; 0 for a row with no
    admissible key), as the kernel's ``rows`` route writes it."""
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q_start, kv_len, B, Sq, Skv, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    l = p.sum(dim=-1, keepdim=True)
    out = out / l.clamp_min(1e-30)
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.zeros_like(l))
    return out, lse[..., 0].permute(0, 1, 3, 2).reshape(B, Kh, Sq * G)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, q_start,
                            kv_len, *, window: int | None = None,
                            softcap: float | None = None,
                            out: torch.Tensor | None = None,
                            lse: torch.Tensor | None = None):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention_ref`` at
    (q, k, v) for the output gradient ``dout``.  A query with no admissible
    key gets zero gradients (its output is the constant 0).

    Without ``out`` and ``lse``: autograd through the plain forward,
    recomputed here.  With both (the forward's output and its
    ``return_lse`` log-sum-exp: the kernel's saved route), the closed form
    the kernels compute: ``P = exp(c - lse)`` over the admissible keys,
    ``D = rowsum(dout * out)``, ``dS = P (dout v - D)`` times the cap's
    derivative, ``dq = dS k / sqrt(hd)``, ``dk = dS^T q / sqrt(hd)``,
    ``dv = P^T dout``."""
    if out is None or lse is None:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = flash_attention_ref(*leaves, q_start, kv_len, window=window,
                                    softcap=softcap)
            return torch.autograd.grad(o, leaves, dout)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    dcap = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    mask = _mask(q_start, kv_len, B, Sq, Skv, window, q.device)
    L = lse.float().reshape(B, Kh, Sq, G).permute(0, 1, 3, 2)[..., None]
    p = torch.exp((s - L).masked_fill(~mask, NEG_INF))
    D = (do * out.float()).sum(-1).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - D) * dcap
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
