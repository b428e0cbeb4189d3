"""ArchBundle: the interface every architecture implements, the port of
``src/repro/configs/base.py``.

A bundle knows, per input shape:
- ``input_specs(shape)``      — the step's arguments on the ``meta`` device
  (the model, its optimizer state, the batch; nothing allocated), with a
  decode step's position a host int;
- ``make_step(shape)``        — the step callable;
- ``shardings(mesh, shape)``  — (in_shardings, out_shardings, hint table)
  for a mesh, in the reference's tree format (``reference_specs``);
- ``make_concrete(shape)``    — real small tensors for smoke runs.

``launch/dryrun.py`` composes these into one counted run of the step on
``meta`` for every (arch x shape x mesh) cell.

The port has no SPMD partitioner, so a sharding is a record: a mesh (a
``launch.mesh.AbstractMesh``, a torch ``DeviceMesh`` or anything with
``axis_names`` and a ``shape`` mapping, such as jax's ``AbstractMesh``) and
a ``PartitionSpec``, whose ``shard_shape`` follows jax's
``NamedSharding.shard_shape``.  An abstract array is a ``ShapeDtype``
record (``sds``) or a meta tensor.  Trees are dicts (leaves in sorted key
order, as ``jax.tree.flatten`` takes them), lists, tuples and NamedTuples;
``None`` is an empty subtree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode | serve | retrieval
    dims: dict
    skip: str | None = None  # reason string when cell is skipped


class ShapeDtype(NamedTuple):
    """An abstract array: the reference's ``jax.ShapeDtypeStruct``."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class PartitionSpec(tuple):
    """jax's ``PartitionSpec``: per array axis None, a mesh axis name or a
    tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """Axis name -> size of a mesh: a torch ``DeviceMesh``
    (``mesh_dim_names``) or anything with ``axis_names`` and a ``shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


class NamedSharding:
    """A mesh and a ``PartitionSpec``: the reference's ``NamedSharding``
    as a record (the port places nothing by it but ``train/elastic.py``'s
    DTensors)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_axes(self.mesh)}, {self.spec!r})"

    def axis_names(self, ndim: int) -> list:
        """Per array axis, the tuple of mesh axes it is split over."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec!r} has {len(self.spec)} entries "
                             f"for an array of rank {ndim}")
        out, used = [], set()
        for part in list(self.spec) + [None] * (ndim - len(self.spec)):
            names = (() if part is None else (part,) if isinstance(part, str)
                     else tuple(part))
            for a in names:
                if a in used:
                    raise ValueError(f"{self.spec!r} maps mesh axis {a!r} "
                                     f"to more than one array axis")
                used.add(a)
            out.append(names)
        return out

    def partitions(self, ndim: int) -> tuple:
        """Per array axis, the number of pieces it is split into."""
        sizes = mesh_axes(self.mesh)
        for names in self.axis_names(ndim):
            for a in names:
                if a not in sizes:
                    raise ValueError(f"{self.spec!r} names {a!r}, not an "
                                     f"axis of the mesh {sizes}")
        return tuple(math.prod(sizes[a] for a in names)
                     for names in self.axis_names(ndim))

    def shard_shape(self, global_shape) -> tuple:
        """The per-device shape, as jax's ``NamedSharding.shard_shape``:
        raises where a split axis does not divide."""
        global_shape = tuple(int(s) for s in global_shape)
        parts = self.partitions(len(global_shape))
        for dim, (s, p) in enumerate(zip(global_shape, parts)):
            if s % p:
                raise ValueError(
                    f"{self!r} implies that array axis {dim} is partitioned "
                    f"{p} times, but the dimension size is {s} (full shape: "
                    f"{global_shape}, per-dimension tiling factors: "
                    f"{list(parts)} should evenly divide the shape)")
        return tuple(s // p for s, p in zip(global_shape, parts))

    def padded_shard_shape(self, global_shape) -> tuple:
        """The per-device shape of an uneven split (each piece rounded up,
        as XLA pads a sharding constraint that does not divide)."""
        parts = self.partitions(len(global_shape))
        return tuple(-(-int(s) // p) for s, p in zip(global_shape, parts))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def ns(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def sds(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(int(x) for x in shape), dtype)


# ------------------------------------------------------------------ trees


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(
        x, (ShapeDtype, PartitionSpec))


def tree_flatten_with_path(tree, path=()) -> list:
    """``(path, leaf)`` pairs in ``jax.tree.flatten``'s order, each path a
    tuple of jax's key strings (``['name']``, ``[i]``, ``.field``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k],
                                                 path + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, ShapeDtype):
        return [pl for f in tree._fields
                for pl in tree_flatten_with_path(getattr(tree, f),
                                                 path + (f".{f}",))]
    if _is_node(tree):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (f"[{i}]",))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, ShapeDtype):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_sds(tree):
    return tree_map(lambda x: sds(x.shape, x.dtype), tree)


def params_spec_like(tree, fn) -> Any:
    """Build a sharding tree by mapping ``fn(path_tuple, leaf)``."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (f"[{k!r}]",)) for k, v in node.items()}
        if _is_node(node):
            return type(node)(walk(v, path + (f"[{i}]",))
                              for i, v in enumerate(node))
        return fn(path, node)
    return walk(tree, ())


def zero1(spec: PartitionSpec, shape, data_size: int, mesh) -> PartitionSpec:
    """ZeRO-1: add 'data' sharding to an optimizer-state leaf on the first
    axis that is unsharded and divisible by the data-axis size."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in [p for p in parts if p]:
        return P(*parts)
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % data_size == 0 and d >= data_size:
            parts[i] = "data"
            return P(*parts)
    return P(*parts)


def replicate_tree(mesh, tree):
    return tree_map(lambda _: ns(mesh), tree)


def metrics_sharding(mesh, metrics_sds):
    return tree_map(lambda _: ns(mesh), metrics_sds)


def to_torch(tree, device=None):
    """Every array leaf as a tensor on ``device`` (the reference's
    ``to_jnp``)."""
    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=device),
                    tree)


def rand_tokens(rng: np.random.Generator, shape, vocab: int):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


# ------------------------------------------------ the reference's format


def _stacked(leaf) -> ShapeDtype:
    """A tree leaf as a record: a tensor, or a list of per-layer tensors
    (a leaf the reference stacks on a leading axis; a list of scalars is
    one scalar, as the reference keeps one compression residual a leaf
    while compression is off)."""
    if isinstance(leaf, list):
        first = leaf[0]
        if first.dim() == 0:
            return sds((), first.dtype)
        return sds((len(leaf),) + tuple(first.shape), first.dtype)
    return sds(leaf.shape, leaf.dtype)


def _records(tree):
    """A reference tree of tensors (``reference_tree()``) as records."""
    if isinstance(tree, dict):
        return {k: _records(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_records(v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_records(getattr(tree, f))
                            for f in tree._fields))
    return _stacked(tree)


def reference_specs(args) -> tuple:
    """A step's arguments (``input_specs`` or real tensors) as the
    reference's argument tree of ``ShapeDtype`` records, which the
    shardings of ``ArchBundle.shardings`` match leaf for leaf: a model
    (anything with ``reference_tree()``) as its parameter tree, a model
    followed by its ``AdamState`` as the reference's ``(params,
    AdamState(step, mu, nu, ef_error))``, a dict by key, a tensor as its
    record, a host int as an int32 scalar (the reference's ``jnp.int32``
    position)."""
    from repro_torch.train.checkpoint import state_tree
    args, out, i = list(args), [], 0
    while i < len(args):
        a = args[i]
        if (isinstance(a, torch.nn.Module) and i + 1 < len(args)
                and isinstance(args[i + 1], opt_mod.AdamState)):
            out.extend(_records(x) for x in state_tree((a, args[i + 1])))
            i += 2
            continue
        if isinstance(a, torch.nn.Module):
            out.append(_records(a.reference_tree()))
        elif isinstance(a, int):
            out.append(sds((), torch.int32))
        else:
            out.append(tree_map(lambda x: sds(x.shape, x.dtype), a))
        i += 1
    return tuple(out)


def shard_bytes(specs, shardings) -> int:
    """Per-device bytes of a record tree under a matching sharding tree
    (a ``None`` sharding, which the reference leaves to XLA, counts the
    leaves whole)."""
    total = 0
    for (path, leaf), sh in zip(tree_flatten_with_path(specs),
                                _shardings_like(specs, shardings)):
        shape = leaf.shape if sh is None else sh.shard_shape(leaf.shape)
        total += math.prod(shape) * _itemsize(leaf.dtype)
    return total


def _shardings_like(specs, shardings) -> list:
    """The sharding of every leaf of ``specs``: ``shardings`` has the same
    structure, or a ``None`` where a whole subtree is left open."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return [shardings] * len(tree_leaves(specs))
    if isinstance(specs, dict):
        if set(specs) != set(shardings):
            raise ValueError(f"sharding keys {sorted(shardings)} do not "
                             f"match {sorted(specs)}")
        return [s for k in sorted(specs)
                for s in _shardings_like(specs[k], shardings[k])]
    if isinstance(specs, tuple) and hasattr(specs, "_fields") \
            and not isinstance(specs, ShapeDtype):
        return [s for f in specs._fields
                for s in _shardings_like(getattr(specs, f),
                                         getattr(shardings, f))]
    if _is_node(specs):
        if len(specs) != len(shardings):
            raise ValueError(f"{len(shardings)} shardings for "
                             f"{len(specs)} subtrees")
        return [s for a, b in zip(specs, shardings)
                for s in _shardings_like(a, b)]
    raise ValueError(f"a leaf {specs!r} meets the subtree {shardings!r}")


class ArchBundle:
    arch_id: str = ""
    family: str = ""              # lm | gnn | recsys
    shapes: dict[str, ShapeSpec] = {}

    # ---- to implement ----------------------------------------------------
    def init_params_abstract(self):
        """The model on the meta device."""
        raise NotImplementedError

    def make_step(self, shape: str) -> Callable:
        raise NotImplementedError

    def input_specs(self, shape: str):
        """The full argument tuple of make_step(shape) on the meta
        device."""
        raise NotImplementedError

    def shardings(self, mesh, shape: str):
        """(in_shardings, out_shardings, hints) for make_step(shape), in
        the reference's tree format (``reference_specs``)."""
        raise NotImplementedError

    def make_concrete(self, shape: str, seed: int = 0, device=None):
        """Real small tensors for smoke testing (``None`` means cuda)."""
        raise NotImplementedError

    # ---- common ----------------------------------------------------------
    def adam_cfg(self) -> opt_mod.AdamWConfig:
        return opt_mod.AdamWConfig()

    def abstract_adam_state(self, model) -> opt_mod.AdamState:
        """The optimizer state of ``model`` (on ``model``'s device: meta
        for an abstract model)."""
        return opt_mod.init(self.adam_cfg(), model.parameters())

    def model_flops(self, shape: str) -> float:
        """Analytic MODEL_FLOPS for the roofline table (global, per
        step)."""
        return 0.0

    def shape_names(self) -> list[str]:
        return list(self.shapes)


def opt_state_shardings(mesh, pshard, ost_specs) -> opt_mod.AdamState:
    """The reference's optimizer-state shardings of the GNN and recsys
    bundles: the moments as the parameters, the step and the compression
    residuals replicated."""
    return opt_mod.AdamState(
        step=ns(mesh), mu=pshard, nu=pshard,
        ef_error=tree_map(lambda _: ns(mesh), ost_specs.ef_error))
