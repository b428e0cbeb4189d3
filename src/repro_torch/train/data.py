"""Deterministic, resumable synthetic token pipeline.

At 1000+ nodes the data layer must (a) never re-read state to resume — batch
``i`` is a pure function of (seed, i); (b) shard by host without overlap.
This pipeline is exactly that: ``batch_at(step)`` is stateless, so restart
after preemption resumes mid-epoch for free and elastic re-scales only change
``n_hosts``/``host_id``.

Synthetic text: a mixture of Zipfian unigrams and deterministic "skip-gram"
structure so a real LM loss signal exists (tests assert learnability).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The host's shard of global batch ``step`` — pure and deterministic."""
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    z = rng.zipf(1.3, size=(B, S)).astype(np.int64)
    toks = (z - 1) % V
    # inject learnable structure: token[t] == token[t-2] + 1 on even runs
    runs = rng.random((B, S)) < 0.35
    shifted = np.roll(toks, 2, axis=1) + 1
    toks = np.where(runs, shifted % V, toks)
    return {"tokens": toks.astype(np.int32)}


class TokenPipeline:
    """Iterator facade with prefetch-free determinism."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_at(self.cfg, self.step)
        self.step += 1
        return b
