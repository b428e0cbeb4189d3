"""The shape record of the reference's ``configs/base.py``: one named input
shape of a model (the rest of that module, ``ArchBundle`` and its mesh
helpers, belongs to the dry-run and launch tooling, not yet ported).  The
GNN family's bundle, without its mesh members, is
``configs/gnn_common.py::GNNBundle``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode | serve | retrieval
    dims: dict
    skip: str | None = None  # reason string when cell is skipped
