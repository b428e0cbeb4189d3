"""Meshes, the port of ``src/repro/launch/mesh.py``.

Must stay FUNCTIONS (importing this module touches no device and no
process group).  Single pod: 16x16 = 256 devices ("data", "model");
multi-pod: 2x16x16 = 512 ("pod", "data", "model"), the pod axis pure data
parallelism.  The production meshes are abstract (``AbstractMesh``: axis
names and sizes, no devices), as the reference's dry run lowers onto
jax's; the host mesh is a ``torch.distributed`` ``DeviceMesh`` over the
local ranks.
"""
from __future__ import annotations

import collections
import math


class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` maps a name to its size
    in order, as jax's ``AbstractMesh``."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(
            zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


def _make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default process
    group, whose world must be ``prod(shape)`` ranks (one device a rank:
    cuda where a card is present, else cpu)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(device_type: str | None = None):
    """``(n, 1)`` over ("data", "model"), one rank a device: ``n`` is the
    world size of the default process group, which must exist (on one
    card a world of one, e.g. an NCCL group over a ``HashStore``)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no default process group; "
                           "initialise torch.distributed first")
    return _make_mesh((dist.get_world_size(), 1), ("data", "model"),
                      device_type)
