"""Batched LM serving engine over a fixed slot pool, the port of
``src/repro/serve/engine.py``.

A fixed number of slots share one KV cache (``[L, slots, S_max, Kh, hd]``).
Requests occupy free slots, prefill writes a prompt into its slot's cache
region (one slot at a time), and one decode step advances every slot per
tick.  Finished slots (EOS, ``max_tokens`` or a full slot) free at once and
are refilled from the queue.  The scheduling is the reference's exactly,
because it changes results: every tick decodes all ``n_slots`` slots, the
idle ones with token 0 at their stale position, and those rows compete for
MoE expert capacity like the others.  Results cross to the host once per
prefill and once per tick (the argmax tokens).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # int32 [prompt_len]
    max_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: tfm.TransformerConfig, params: tfm.Transformer,
                 n_slots: int = 4, max_len: int = 512, eos_id: int = 0,
                 greedy: bool = True, device=None):
        """``device=None`` means cuda (raises without a card); ``params``
        must already live on the device.  ``greedy`` is accepted and
        ignored, as in the reference: decoding is always greedy."""
        self.device = resolve_device(device)
        held = {p.device for p in params.parameters()}
        if held != {self.device}:
            raise ValueError(f"params are on {sorted(map(str, held))}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_id
        self.caches = tfm.init_kv_cache(cfg, n_slots, max_len,
                                        device=self.device)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int32)
        self.queue: deque[Request] = deque()
        self.ticks = 0

    # --------------------------------------------------------------- public
    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_ticks: int = 1000) -> list[Request]:
        finished = []
        while (self.queue or any(self.slot_req)) and self.ticks < max_ticks:
            self._admit()
            self._step(finished)
            self.ticks += 1
        return finished

    # -------------------------------------------------------------- private
    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """One-slot prefill into the shared cache at ``slot`` (the slot's
        cache rows are views, written in place).  Returns logits [1, V]."""
        view = {n: c[:, slot:slot + 1] for n, c in self.caches.items()}
        logits, _, _ = tfm.forward(self.params, tokens, self.cfg,
                                   kv_caches=view, cache_index=0)
        return logits[:, -1]

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor):
        logits, _ = tfm.decode_step_multi(self.params, tokens, self.cfg,
                                          self.caches, pos)
        return logits

    def _admit(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                toks = torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None, :],
                    device=self.device)
                logits = self._prefill(toks, s)
                req.out_tokens.append(int(torch.argmax(logits[0])))
                self.slot_req[s] = req
                self.slot_pos[s] = len(req.prompt)

    def _step(self, finished: list):
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return
        tokens = np.zeros((self.n_slots, 1), np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].out_tokens[-1]
        logits = self._decode(torch.as_tensor(tokens, device=self.device),
                              torch.tensor(self.slot_pos,
                                           device=self.device))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out_tokens.append(tok)
            self.slot_pos[s] += 1
            if (tok == self.eos or len(req.out_tokens) >= req.max_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.slot_req[s] = None
