"""End-to-end LM training, the port of ``src/repro/launch/train.py``.

Composes the substrate: config -> data pipeline -> train step ->
fault-tolerant loop with async checkpointing, on one device (cuda unless
``--device`` says otherwise; cuda without a card raises).

    PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, batch_at
from repro_torch.train.loop import LoopConfig, run_loop

PRESETS = {
    # the reference's "train a ~100M model" preset (163.6M weights by
    # param_count, the embedding and the head included)
    "lm100m": tfm.TransformerConfig(
        name="lm100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=32768, block_q=128, block_kv=128,
        dtype=torch.float32),
    "lm10m": tfm.TransformerConfig(
        name="lm10m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=1024, vocab_size=8192, block_q=64, block_kv=64,
        dtype=torch.float32),
    "lm-moe": tfm.TransformerConfig(
        name="lm-moe", n_layers=4, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=512, vocab_size=8192, moe=True, n_experts=8, top_k=2,
        block_q=64, block_kv=64, dtype=torch.float32),
}


def train(preset: str = "lm10m", steps: int = 100, batch: int = 4,
          seq: int = 128, ckpt_dir: str | None = None, lr: float = 3e-4,
          compress_grads: bool = False, log_fn=print,
          should_preempt=lambda: False, *, device=None,
          log_every: int = 10):
    """Train ``preset`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint; by default ``repro_torch_ckpt`` under the temporary
    directory) on ``device`` (``None`` means cuda).  Weights come
    from a ``torch.Generator`` seeded 0 on the device; ``log_every`` sets
    how often the loop records metrics.  Returns the loop's
    ``LoopResult``."""
    cfg = PRESETS[preset]
    dev = resolve_device(device)
    acfg = opt_mod.AdamWConfig(lr=lr, warmup_steps=min(50, steps // 10 + 1),
                               total_steps=steps,
                               compress_grads=compress_grads)
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt_state = opt_mod.init(acfg, model.parameters())
    train_step = tfm.make_train_step(cfg, acfg)

    def step_fn(state, batch):
        model, opt_state = state
        model, opt_state, metrics = train_step(model, opt_state, batch)
        return (model, opt_state), metrics

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)

    def batch_fn(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in batch_at(dcfg, step).items()}

    ckpt = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
        keep=2)
    loop_cfg = LoopConfig(total_steps=steps,
                          ckpt_every=max(steps // 4, 10),
                          log_every=log_every)
    return run_loop(step_fn, (model, opt_state), batch_fn, ckpt, loop_cfg,
                    should_preempt=should_preempt, log_fn=log_fn)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="lm10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt under the temp dir")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    result = train(a.preset, a.steps, a.batch, a.seq, a.ckpt_dir, a.lr,
                   a.compress_grads, device=a.device)
    print(f"done: step={result.final_step} retries={result.retries} "
          f"stragglers={result.straggler_steps}")
    if result.metrics_history:
        first = result.metrics_history[0][1]["loss"]
        last = result.metrics_history[-1][1]["loss"]
        print(f"loss {first:.4f} -> {last:.4f}")
    return result


if __name__ == "__main__":
    main()
