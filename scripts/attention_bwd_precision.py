#!/usr/bin/env python3
"""The sizes behind the backward kernel phases' checks in ``chip_smoke.py``
(``attention_bwd``, ``gmm_bwd``), on the CPU at small batches.

    PYTHONPATH=src python3 scripts/attention_bwd_precision.py

from the repository root.  Each preset is cut to 2 layers (layer 0's
inputs do not depend on the layers after it) with the seeded random
weights of ``init_params`` and one batch of the synthetic token pipeline;
layer 0's attention and MoE operands and their output gradients are
captured through ``loss_fn``'s backward.

1. ``magnitudes``: the largest and the RMS value of each gradient when the
   captured output gradient is scaled to unit RMS, as the smoke scales it:
   K2's dq, dk, dv in fp32 and bf16 (``lm100m``, 1 x 1,024; ``lm-moe``,
   2 x 512) and K3's dx, dw for the w1 and w2 products (``lm-moe``).
2. ``emulation``: K2's backward in bf16 computed in fp64 as the kernels
   compute it, with D = rowsum(dout * o) taken from the forward's output
   rounded to bf16 or from the exact one, and dq held against autograd
   through the plain version at the smoke's bf16 tolerance, 2e-2
   (``lm100m``, 2 x 1,024).

Prints one JSON line per result.  Untrained weights: the smoke captures
after 30 training steps and at 8 x 1,024 tokens, where the gradients run
larger.
"""
from __future__ import annotations

import dataclasses
import json
import math

import torch

from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.launch.train import PRESETS
from repro_torch.models import transformer as tfm
from repro_torch.train.data import DataConfig, batch_at

TOL_BF16 = 2e-2


def unit_rms(t: torch.Tensor) -> torch.Tensor:
    t32 = t.float()
    return (t32 / t32.square().mean().sqrt()).to(t.dtype)


def capture(preset: str, batch: int, seq: int) -> dict:
    """Layer 0's attention operands ``[q, k, v, q_start, kv_len, kw,
    dout]`` under ``"attention"`` and, for MoE, ``[x, w, dy]`` under
    ``"w1"`` and ``"w2"``."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(PRESETS[preset], n_layers=2)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    mlp0 = model.layers[0].mlp
    cap = {}
    real_fa, real_gmm = tfm.flash_attention, tfm.grouped_matmul

    def keep(key, out):
        out.register_hook(lambda g: cap[key].append(g.detach()))

    def fa(q, k, v, q_start, kv_len, **kw):
        out = real_fa(q, k, v, q_start, kv_len, **kw)
        if "attention" not in cap and out.requires_grad:
            cap["attention"] = [q.detach(), k.detach(), v.detach(), q_start,
                                kv_len, kw]
            keep("attention", out)
        return out

    def gmm(x, w):
        out = real_gmm(x, w)
        which = {mlp0.w1.data_ptr(): "w1",
                 mlp0.w2.data_ptr(): "w2"}.get(w.data_ptr())
        if which and which not in cap and out.requires_grad:
            cap[which] = [x.detach(), w.detach()]
            keep(which, out)
        return out

    tokens = torch.as_tensor(batch_at(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                   global_batch=batch), 0)["tokens"])
    tfm.flash_attention, tfm.grouped_matmul = fa, gmm
    try:
        params = [p.requires_grad_() for p in model.parameters()]
        loss, _ = tfm.loss_fn(model, {"tokens": tokens}, cfg)
        torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        tfm.flash_attention, tfm.grouped_matmul = real_fa, real_gmm
    return cap


def sizes(names: str, grads) -> dict:
    return {f"d{n}": {"max_abs": float(g.float().abs().max()),
                      "rms": float(g.float().square().mean().sqrt())}
            for n, g in zip(names, grads)}


def magnitudes(preset: str, batch: int, seq: int) -> None:
    cap = capture(preset, batch, seq)
    q, k, v, q_start, kv_len, kw, dout = cap["attention"]
    for dt in (torch.float32, torch.bfloat16):
        grads = flash_attention_bwd_ref(q.to(dt), k.to(dt), v.to(dt),
                                        unit_rms(dout).to(dt), q_start,
                                        kv_len, **kw)
        print(json.dumps({"magnitudes": "attention", "preset": preset,
                          "batch": batch, "seq": seq, "dtype": str(dt),
                          "captured_dout_rms": float(
                              dout.square().mean().sqrt()),
                          **sizes("qkv", grads)}))
    for which in ("w1", "w2"):
        if which not in cap:
            continue
        x, w, dy = cap[which]
        xg, wg = (t.clone().requires_grad_() for t in (x, w))
        grads = torch.autograd.grad(grouped_matmul_ref(xg, wg), (xg, wg),
                                    unit_rms(dy))
        print(json.dumps({"magnitudes": which, "preset": preset,
                          "shape": list(x.shape),
                          "captured_dy_rms": float(dy.square().mean().sqrt()),
                          **sizes("xw", grads)}))


def emulation(preset: str, batch: int, seq: int) -> None:
    cap = capture(preset, batch, seq)
    q, k, v, q_start, kv_len, kw, dout = cap["attention"]
    assert kw.get("window") is None and kw.get("softcap") is None \
        and q_start == 0, "the emulation is causal from position 0 only"
    bf = torch.bfloat16
    qb, kb, vb, db = q.to(bf), k.to(bf), v.to(bf), unit_rms(dout).to(bf)
    want = flash_attention_bwd_ref(qb, kb, vb, db, q_start, kv_len)[0]
    Q, K, V, DO = (t.double() for t in (qb, kb, vb, db))
    hd = Q.shape[-1]
    scale = 1 / math.sqrt(hd)
    S = Q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.einsum("bqkgd,bskd->bkgqs", Q, K) * scale
    p = torch.softmax(s.masked_fill(~mask, -1e30), -1) * mask
    exact = torch.einsum("bkgqs,bskd->bqkgd", p, V)
    rounded = flash_attention_ref(qb, kb, vb, q_start, kv_len).double()
    dp = torch.einsum("bqkgd,bskd->bkgqs", DO, V)
    for name, o in (("rounded", rounded), ("exact", exact)):
        d = (DO * o).sum(-1).permute(0, 2, 3, 1)[..., None]
        dq = torch.einsum("bkgqs,bskd->bqkgd", p * (dp - d), K) * scale
        got = dq.to(bf).float()
        diff = (got - want.float()).abs()
        limit = TOL_BF16 + TOL_BF16 * want.float().abs()
        print(json.dumps({"emulation": f"D from the {name} output",
                          "preset": preset, "batch": batch, "seq": seq,
                          "max_abs_err": float(diff.max()),
                          "worst_of_tol": float((diff / limit).max())}))


def main() -> None:
    magnitudes("lm100m", 1, 1024)
    magnitudes("lm-moe", 2, 512)
    emulation("lm100m", 2, 1024)


if __name__ == "__main__":
    main()
