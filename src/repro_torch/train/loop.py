"""Fault-tolerant training loop, the port of ``src/repro/train/loop.py``.

The reference's behaviours, step for step:
- checkpoint/restart: periodic async checkpoints; on (re)start the loop
  restores the latest readable checkpoint and resumes the data pipeline at
  the exact step (data is stateless — train/data.py);
- bounded retry on transient step failures, with re-materialisation from
  the last checkpoint after repeated failures;
- preemption handling: a ``should_preempt`` callback triggers a final
  checkpoint and a clean exit;
- straggler watchdog: per-step wall-time EMA; steps slower than
  ``straggler_factor`` x EMA are logged and counted.

Where the reference rebuilds its state from a restored tree, the port
restores into the state's tensors in place (``CheckpointManager.restore``).
A step's time ends with one device synchronisation, so the watchdog
measures the device's step, not the host's enqueue.  A step whose failure
comes after the optimizer began writing its parameters in place is retried
from what was written; re-materialising from the checkpoint restores a
consistent state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class LoopResult:
    final_step: int
    metrics_history: list
    retries: int
    straggler_steps: int
    preempted: bool


def _sync(metrics: dict) -> None:
    """Wait for the card that ran the step (its metrics' device); a step
    on the CPU has nothing to wait for."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def run_loop(step_fn: Callable, state, batch_fn: Callable,
             ckpt: CheckpointManager, cfg: LoopConfig,
             should_preempt: Callable[[], bool] = lambda: False,
             log_fn: Callable = print) -> LoopResult:
    """state: passed to/returned by ``step_fn(state, batch)`` (plus a
    metrics dict), e.g. ``(model, AdamState)``. ``batch_fn(step)`` supplies
    data."""
    start, restored = ckpt.restore_latest(state)
    if start is not None:
        state = restored
        log_fn(f"[loop] restored checkpoint at step {start}")
        step = start
    else:
        step = 0

    history = []
    retries = 0
    stragglers = 0
    ema = None
    preempted = False
    while step < cfg.total_steps:
        if should_preempt():
            log_fn(f"[loop] preemption signal at step {step}; checkpointing")
            ckpt.save(step, state)
            ckpt.wait()
            preempted = True
            break
        batch = batch_fn(step)
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                state, metrics = step_fn(state, batch)
                _sync(metrics)
                break
            except Exception as e:  # noqa: BLE001 — transient failure path
                attempt += 1
                retries += 1
                log_fn(f"[loop] step {step} failed ({type(e).__name__}: {e});"
                       f" retry {attempt}/{cfg.max_retries}")
                if attempt > cfg.max_retries:
                    s, restored = ckpt.restore_latest(state)
                    if s is None:
                        raise
                    log_fn(f"[loop] re-materializing from checkpoint {s}")
                    state = restored
                    step = s
                    batch = batch_fn(step)
                    attempt = 0
        dt = time.perf_counter() - t0
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if dt > cfg.straggler_factor * ema and step > 5:
            stragglers += 1
            log_fn(f"[loop] straggler step {step}: {dt:.3f}s vs ema "
                   f"{ema:.3f}s")
        step += 1
        if step % cfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((step, m))
            log_fn(f"[loop] step {step}: " +
                   " ".join(f"{k}={v:.4g}" for k, v in m.items()))
        if step % cfg.ckpt_every == 0:
            ckpt.save(step, state)
    ckpt.save(step, state)
    ckpt.wait()
    return LoopResult(step, history, retries, stragglers, preempted)
