"""Sharding-hint plumbing, the port of ``src/repro/models/sharding.py``.

Models are mesh-agnostic; launchers install a hint table mapping logical
activation names to shardings (``configs.base.NamedSharding``).
``shard_hint(x, name)`` returns ``x`` itself: the port runs a step on one
device, so a hint places nothing.  With no table installed it does nothing
else, so serving and training are untouched.  Under an installed table
(``launch/dryrun.py``) it records, per hinted name, the calls and the
largest per-device bytes of the activation under its sharding (an uneven
split rounded up, as XLA pads a sharding constraint), in the dict that
``hint_context`` yields.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

_state = threading.local()


def _table() -> dict:
    return getattr(_state, "hints", None) or {}


@contextlib.contextmanager
def hint_context(hints: dict):
    """Install ``hints`` (name -> sharding) for the block; yields the
    record ``{name: {"calls", "bytes_per_device"}}`` it fills."""
    old = (getattr(_state, "hints", None), getattr(_state, "seen", None))
    _state.hints, _state.seen = hints, {}
    try:
        yield _state.seen
    finally:
        _state.hints, _state.seen = old


def shard_hint(x: torch.Tensor, name: str) -> torch.Tensor:
    h = _table().get(name)
    if h is None:
        return x
    rec = _state.seen.setdefault(name, {"calls": 0, "bytes_per_device": 0})
    rec["calls"] += 1
    rec["bytes_per_device"] = max(
        rec["bytes_per_device"],
        math.prod(h.padded_shard_shape(x.shape)) * x.element_size())
    return x
