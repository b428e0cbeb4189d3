"""The system under test, built from a configuration file.

A system module gives ``data(config, seed)``, the raw arrays it serves
(made from the seed; the control and the reference are built on them
too), ``build(config, seed, device)``, the system over them, and
``CPU_SIZES``, the configuration keys that shrink it for the CPU tests.

This one generates the raw arrays with the frozen generator
(``snb.generate``) and hands them to the port through ``build_store`` with
the port's ``ldbc_schema()``.  ``GOpt(store)`` runs on the card
(``device=None``); the CPU tests pass ``device="cpu"``.  A system that
serves other arrays in the same schema builds through ``build_with``.
"""
from __future__ import annotations

import copy
import dataclasses
import time

from perfbench import snb

CPU_SIZES = {"generator_scale": 0.5}


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


def data(config: dict, seed: int) -> snb.RawGraph:
    return snb.generate(config["generator_scale"], seed)


def build(config: dict, seed: int, device: str | None) -> System:
    return build_with(data, config, seed, device)


def build_with(make_data, config: dict, seed: int,
               device: str | None) -> System:
    """The port's store over ``make_data(config, seed)`` and ``GOpt`` on
    it (``generate_s``: making the data and the store)."""
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.schema import EdgeTriple, ldbc_schema
    from repro_torch.graphdb.storage import build_store
    t0 = time.perf_counter()
    raw = make_data(config, seed)
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
