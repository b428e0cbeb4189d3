"""Elastic scaling: place a training state on a (different) mesh, the port
of ``src/repro/train/elastic.py``.

Checkpoints are mesh-independent host arrays in the reference's tree
(``train/checkpoint.py``), so elasticity is: restore -> build the new mesh
-> place each leaf by its sharding.  ``reshard`` takes shardings in the
reference's tree format (``ArchBundle.shardings``), whose leaves are the
reference's leaves (a layer leaf stacked ``[L, ...]``):
- on a mesh of one device each leaf goes to that device; a port state
  (``(model, AdamState)`` or a model) keeps its objects, its tensors moved
  in place where they lie elsewhere, and is returned;
- on a mesh of several ranks (a ``DeviceMesh`` over a ``torch.distributed``
  world) each leaf becomes a ``DTensor`` through ``distribute_tensor`` with
  the placements of its ``PartitionSpec`` (``Shard(i)`` on every mesh axis
  that splits array axis ``i``, ``Replicate()`` on the rest), and the
  result is the reference's tree of them (a stacked leaf one DTensor over
  its ``[L, ...]`` stack): the port's modules hold plain tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (mesh_axes, mesh_size, tree_leaves,
                                      tree_map)
from repro_torch.train.checkpoint import flatten, state_tree
from repro_torch.train.optimizer import AdamState


def _is_state(state) -> bool:
    return isinstance(state, nn.Module) or (
        isinstance(state, tuple) and len(state) == 2
        and isinstance(state[0], nn.Module)
        and isinstance(state[1], AdamState))


def mesh_device(mesh) -> torch.device:
    """The device of a one-device ``DeviceMesh`` (cuda: the current
    device)."""
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def placements(sharding, ndim: int) -> list:
    """The DTensor placements of a sharding over an array of rank
    ``ndim``: per mesh axis, ``Shard(i)`` where it splits array axis
    ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {a: i for i, names in enumerate(sharding.axis_names(ndim))
               for a in names}
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh_axes(sharding.mesh)]


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as one tensor: an array, a tensor, or the per-layer tensors
    of a stacked leaf (stacked; a list of scalars is one scalar)."""
    if isinstance(leaf, list):
        if leaf[0].dim() == 0:
            return leaf[0].detach()
        return torch.stack([t.detach() for t in leaf])
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.tensor(np.asarray(leaf))


def _move(t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        t.data = t.data.to(dev)


def _tensor_tree(tree):
    """The reference's tree of a port state (``state_tree``) with each
    stacked leaf (its list of per-layer tensors) as one tensor."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_tensor_tree(v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(
            parts)
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_tensor_tree(v) for v in tree]
    return _as_tensor(tree)


def reshard(state, shardings):
    """Place ``state`` (a port state, or the reference's tree of host
    arrays or tensors) onto ``shardings`` leaf by leaf."""
    mesh = tree_leaves(shardings)[0].mesh
    if mesh_size(mesh) == 1:
        dev = mesh_device(mesh)
        if not _is_state(state):
            return tree_map(lambda x: _as_tensor(x).to(dev), state)
        for leaf in flatten(state_tree(state)):
            for t in (leaf if isinstance(leaf, list) else [leaf]):
                _move(t, dev)
        return state
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, sharding):
        t = _as_tensor(leaf).to(mesh_device(mesh))
        return distribute_tensor(t, mesh, placements(sharding, t.dim()))

    tree = _tensor_tree(state_tree(state)) if _is_state(state) else state
    return tree_map(place, tree, shardings)


def elastic_restart(ckpt, like, new_mesh, sharding_fn):
    """Restore the latest checkpoint into ``like`` and place it on
    ``new_mesh``.

    ``sharding_fn(mesh)`` -> the sharding tree matching ``like`` in the
    reference's format.  Returns (step, placed state) or (None, None)."""
    step, host_state = ckpt.restore_latest(like)
    if step is None:
        return None, None
    return step, reshard(host_state, sharding_fn(new_mesh))
