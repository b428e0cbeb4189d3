"""GAT (Velickovic et al., arXiv:1710.10903), the port of
``src/repro/models/gnn/gat.py``: node classification over padded-COO
graphs, SDDMM logits, a segment softmax by destination node, then the
attention-weighted aggregation; ELU between layers, the head mean on the
last.  For molecule-style inputs (atom types, no dense features) an
embedding table replaces the feature projection.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.common import (ParamTree, masked_nll, safe_edges,
                                           segment_softmax, segment_sum,
                                           take_rows)
from repro_torch.models.sharding import shard_hint
from repro_torch.train.step import make_train_step as _train_step


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    n_atom_types: int = 0          # >0: embed atom types instead of features
    dropout: float = 0.0           # kept for config parity; eval-mode graphs
    negative_slope: float = 0.2
    dtype: Any = torch.float32

    def param_count(self) -> int:
        return sum(p.numel() for p in GAT(self, "meta").parameters())


def _spec(cfg: GATConfig) -> dict:
    layers = []
    d_in = cfg.d_feat if cfg.n_atom_types == 0 else cfg.d_hidden * cfg.n_heads
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({"w": ((d_in, h, d_out), "dense"),
                       "a_src": ((h, d_out), "dense"),
                       "a_dst": ((h, d_out), "dense")})
        d_in = d_out * h if not last else d_out
    spec = {"layers": layers}
    if cfg.n_atom_types:
        spec["embed"] = ((cfg.n_atom_types, cfg.d_hidden * cfg.n_heads),
                         "dense")
    return spec


class GAT(ParamTree):
    def __init__(self, cfg: GATConfig, device):
        super().__init__(_spec(cfg), device)


def init_params(cfg: GATConfig, generator: torch.Generator,
                device=None) -> GAT:
    """Random weights from ``generator`` (on ``device``; ``None`` means
    cuda) with the reference's laws."""
    return GAT(cfg, resolve_device(device)).draw(generator)


def params_from_reference(cfg: GATConfig, arrays: dict, device=None) -> GAT:
    """The reference's parameter tree (numpy arrays) as the port's module
    on ``device`` (``None`` means cuda)."""
    return GAT(cfg, resolve_device(device)).load(arrays)


def forward(model: GAT, batch: dict, cfg: GATConfig) -> torch.Tensor:
    """batch: node_feat [N,F] or atom_type [N]; edges [2,E] padded COO.
    Returns logits [N, n_classes]."""
    src, dst, m = safe_edges(batch["edges"])
    if cfg.n_atom_types:
        x = take_rows(model.embed, batch["atom_type"].clamp_min(0).long())
    else:
        x = batch["node_feat"].to(cfg.dtype)
    N = x.shape[0]
    for i, lp in enumerate(model.layers):
        last = i == cfg.n_layers - 1
        h = torch.einsum("nf,fhd->nhd", x, lp.w.to(cfg.dtype))
        h = shard_hint(h, "node_hidden")
        s_src = torch.einsum("nhd,hd->nh", h, lp.a_src.to(cfg.dtype))
        s_dst = torch.einsum("nhd,hd->nh", h, lp.a_dst.to(cfg.dtype))
        e = F.leaky_relu(take_rows(s_src, src) + take_rows(s_dst, dst),
                         cfg.negative_slope)               # [E, H] (SDDMM)
        alpha = segment_softmax(e, dst, N, mask=m[:, None])
        msg = alpha[..., None] * take_rows(h, src)          # [E, H, D]
        msg = shard_hint(msg, "edge_msg")
        out = segment_sum(msg, dst, N)
        x = out.mean(dim=1) if last else F.elu(out.reshape(N, -1))
    return x


def loss_fn(model: GAT, batch: dict, cfg: GATConfig):
    logits = forward(model, batch, cfg)
    loss, mask = masked_nll(logits, batch)
    acc = torch.sum((logits.argmax(-1) == batch["labels"]) * mask) \
        / torch.clamp(mask.sum(), min=1)
    return loss, {"acc": acc}


def make_train_step(cfg: GATConfig, adam_cfg):
    return _train_step(loss_fn, cfg, adam_cfg)
