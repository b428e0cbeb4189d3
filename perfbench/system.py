"""The system under test, built from a configuration file.

The benchmark generates the raw arrays from the seed (``snb.generate``)
and hands them to the port through ``build_store`` with the port's
``ldbc_schema()``.  ``GOpt(store)`` runs on the card (``device=None``);
the CPU tests pass ``device="cpu"``.
"""
from __future__ import annotations

import copy
import dataclasses
import time

from perfbench import snb


@dataclasses.dataclass
class System:
    raw: snb.RawGraph
    store: object
    gopt: object
    device: str | None
    generate_s: float
    glogue_s: float

    def sync(self):
        if self.device is None:
            import torch
            torch.cuda.synchronize()


def build(config: dict, seed: int, device: str | None) -> System:
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.schema import EdgeTriple, ldbc_schema
    from repro_torch.graphdb.storage import build_store
    t0 = time.perf_counter()
    raw = snb.generate(config["generator_scale"], seed)
    # the port gets its own copies of everything it might write to; the
    # edge lists it only reads
    store = build_store(
        ldbc_schema(), dict(raw.counts),
        {EdgeTriple(*t): e for t, e in raw.edges.items()},
        {t: {k: v.copy() for k, v in p.items()}
         for t, p in raw.v_props.items()},
        {EdgeTriple(*t): {k: v.copy() for k, v in p.items()}
         for t, p in raw.e_props.items()},
        copy.deepcopy(raw.vocab))
    generate_s = time.perf_counter() - t0
    sys_ = System(raw, store, None, device, generate_s, 0.0)
    t0 = time.perf_counter()
    sys_.gopt = GOpt(store, device=device)
    sys_.sync()
    sys_.glogue_s = time.perf_counter() - t0
    return sys_
