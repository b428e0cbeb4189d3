"""Shared GNN primitives, the port of ``src/repro/models/gnn/common.py``:
padded-COO message passing over ``edges [2, E]`` (-1 pads), with the
segment sums as ``index_add_`` and the segment max as ``scatter_reduce``
(``amax``) into a tensor filled with ``-inf``.  The reference runs them as
``jax.ops.segment_sum`` / ``segment_max``, outside any Pallas kernel (the
``segment_matmul`` its docstring names does not exist), so no kernel of
the port lies on this path.

Indices: ``safe_edges`` returns int64 ``src`` / ``dst`` (``scatter_reduce``
and ``index_add_`` take int64), once per forward; the layers reuse them.
The reference's ``shard_hint`` calls stand at its sites
(``models/sharding.py``: no-ops outside the dry run).  Every GNN module's ``make_train_step`` returns the shared step of
``repro_torch.train.step``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import dense_init_
from repro_torch.models.sharding import shard_hint

# ------------------------------------------------------------- parameters


class ParamTree(nn.Module):
    """Parameters under the reference's tree names.  ``spec`` maps a name
    to a leaf ``(shape, law)``, to a sub-tree (a dict) or to a list of
    sub-trees (an ``nn.ModuleList``); ``law`` is ``"dense"`` (the fan-in
    truncated normal), a float (the same law at that scale), ``"zeros"``
    or ``"ones"``.  Float32, uninitialised until ``draw`` or ``load``."""

    def __init__(self, spec: dict, device):
        super().__init__()
        self._laws = {}
        for k, v in spec.items():
            if isinstance(v, dict):
                setattr(self, k, ParamTree(v, device))
            elif isinstance(v, list):
                setattr(self, k, nn.ModuleList(ParamTree(s, device)
                                               for s in v))
            else:
                shape, self._laws[k] = v
                self.register_parameter(k, nn.Parameter(torch.empty(
                    shape, dtype=torch.float32, device=device)))

    # lists of layers the reference stacks on a leading axis
    STACKED: tuple = ()

    def reference_tree(self) -> dict:
        """The parameters in the reference's tree: own leaves by name,
        sub-trees as dicts, a list of sub-trees as a list; a list named in
        ``STACKED`` as one sub-tree whose leaves are the lists of their
        per-layer parameters (the reference stacks them)."""
        out = {k: getattr(self, k) for k in self._laws}
        for k, child in self.named_children():
            if not isinstance(child, nn.ModuleList):
                out[k] = child.reference_tree()
                continue
            subs = [c.reference_tree() for c in child]
            out[k] = _stack(subs) if k in self.STACKED else subs
        return out

    @torch.no_grad()
    def draw(self, generator: torch.Generator) -> "ParamTree":
        """Every parameter drawn from ``generator`` by its law."""
        for k, law in self._laws.items():
            p = getattr(self, k)
            if law == "zeros":
                p.zero_()
            elif law == "ones":
                p.fill_(1.0)
            else:
                dense_init_(p, generator, None if law == "dense" else law)
        for child in self.children():
            for sub in (child if isinstance(child, nn.ModuleList)
                        else [child]):
                sub.draw(generator)
        return self

    @torch.no_grad()
    def load(self, arrays: dict, where: str = "") -> "ParamTree":
        """Copy a reference tree of numpy arrays in, checking that it has
        the same names, list lengths and shapes."""
        mine = set(self._laws) | {k for k, _ in self.named_children()}
        if set(arrays) != mine:
            raise ValueError(f"{where or 'params'}: reference names "
                             f"{sorted(arrays)}, port {sorted(mine)}")
        for k, a in arrays.items():
            name = f"{where}.{k}" if where else k
            if k in self._laws:
                p = getattr(self, k)
                a = np.asarray(a, dtype=np.float32)
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{name}: shape {a.shape}, port "
                                     f"{tuple(p.shape)}")
                p.copy_(torch.tensor(a))
            elif isinstance(a, dict):
                getattr(self, k).load(a, name)
            else:
                subs = getattr(self, k)
                if len(a) != len(subs):
                    raise ValueError(f"{name}: {len(a)} reference entries, "
                                     f"port {len(subs)}")
                for i, (sub, sa) in enumerate(zip(subs, a)):
                    sub.load(sa, f"{name}.{i}")
        return self


def _stack(trees: list):
    """Trees of one structure as one tree of lists (leaf by leaf)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return list(trees)


# ------------------------------------------------------------------ edges


def edge_mask(edges: torch.Tensor) -> torch.Tensor:
    return (edges[0] >= 0) & (edges[1] >= 0)


def safe_edges(edges: torch.Tensor):
    """(src, dst, mask): int64 indices with padded entries clipped to 0."""
    m = edge_mask(edges)
    return (edges[0].clamp_min(0).long(), edges[1].clamp_min(0).long(), m)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 as ``index_select``, whose backward is an
    ``index_add_``: the backward of advanced indexing sorts the indices
    and walks each run of equal ones in turn, and every padded edge points
    at node 0."""
    return torch.index_select(x, 0, idx)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``values`` summed by ``seg``."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, seg, values)


def segment_max(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: ``-inf`` for a segment with no row."""
    out = values.new_full((num_segments,) + tuple(values.shape[1:]),
                          float("-inf"))
    idx = seg.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)


def segment_softmax(logits: torch.Tensor, seg: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax of per-edge logits grouped by destination node.  The
    segment max only shifts the exponent (the softmax does not depend on
    it), so it is taken without a gradient; a segment with no edge (a node
    with no in-edge, a padded node) has max ``-inf``, which is zeroed as
    the reference zeroes it."""
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    with torch.no_grad():
        mx = segment_max(logits, seg, num_segments)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(logits - take_rows(mx, seg))
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    den = segment_sum(ex, seg, num_segments)
    return ex / torch.clamp(take_rows(den, seg), min=1e-16)


def scatter_mean(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    ones = values.new_ones(values.shape[0])
    bshape = (-1,) + (1,) * (values.ndim - 1)
    if mask is not None:
        fm = mask.to(values.dtype)
        values = values * fm.reshape(bshape)
        ones = fm
    s = segment_sum(values, seg, num_segments)
    c = segment_sum(ones, seg, num_segments)
    return s / torch.clamp(c, min=1.0).reshape(bshape)


def gather_dense_scatter(x: torch.Tensor, w: torch.Tensor,
                         edges: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Gather source features, transform, scatter-add to destinations.
    x [N, F], w [F, G] -> [N, G]."""
    src, dst, m = safe_edges(edges)
    msg = (take_rows(x, src) @ w) * m[:, None].to(x.dtype)
    msg = shard_hint(msg, "edge_msg")
    return segment_sum(msg, dst, num_nodes)


# -------------------------------------------------------- radial bases


def gaussian_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """SchNet-style Gaussian radial basis [..., n_rbf]."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=d.dtype,
                             device=d.device)
    gamma = (n_rbf / cutoff) ** 2 * 0.5
    return torch.exp(-gamma * (d[..., None] - centers) ** 2)


def bessel_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP-style Bessel basis."""
    n = torch.arange(1, n_rbf + 1, device=d.device)
    dd = torch.clamp(d[..., None], min=1e-9)
    return ((2.0 / cutoff) ** 0.5 * torch.sin(n * torch.pi * dd / cutoff)
            / dd)


def poly_cutoff(d: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff envelope (goes to 0 at d=cutoff)."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    return (1.0 - 0.5 * (p + 1) * (p + 2) * x ** p
            + p * (p + 2) * x ** (p + 1)
            - 0.5 * p * (p + 1) * x ** (p + 2))


def edge_vectors(positions: torch.Tensor, edges: torch.Tensor):
    """(rhat [E,3], dist [E], mask [E]) from positions and padded COO."""
    src, dst, m = safe_edges(edges)
    vec = take_rows(positions, dst) - take_rows(positions, src)
    d = torch.linalg.vector_norm(vec, dim=-1)
    rhat = vec / torch.clamp(d[:, None], min=1e-9)
    return rhat, d, m


# --------------------------------------------------------------- losses


def masked_nll(logits: torch.Tensor, batch: dict):
    """Mean NLL of ``labels`` over ``train_mask`` (ones by default) where
    ``labels >= 0``, and that mask."""
    labels = batch["labels"]
    mask = batch.get("train_mask")
    if mask is None:
        mask = torch.ones(labels.shape, device=labels.device)
    mask = mask * (labels >= 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0).long()[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1), mask


def energy_loss(out: torch.Tensor, batch: dict):
    err = out - batch["energy"]
    return torch.mean(torch.square(err)), {"mae": torch.mean(torch.abs(err))}


def graph_readout(h: torch.Tensor, batch: dict, n_graphs: int):
    """Per-graph energies from per-node outputs ``h [N, 1]``: the sum over
    all nodes without ``graph_ids``; otherwise padded nodes
    (``graph_id == -1``) go to a spill segment ``n_graphs``, dropped."""
    graph_ids = batch.get("graph_ids")
    if graph_ids is None:
        return h.sum(dim=0)
    seg = torch.where(graph_ids >= 0, graph_ids, n_graphs).long()
    return segment_sum(h[:, 0], seg, n_graphs + 1)[:n_graphs]
