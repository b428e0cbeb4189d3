"""SchNet (Schutt et al., arXiv:1706.08566), the port of
``src/repro/models/gnn/schnet.py``: continuous-filter convolutions.
Messages are element-wise products of neighbour features with a learned
filter of the interatomic distance (Gaussian RBF -> filter MLP),
aggregated by a segment sum.  Energy = sum of per-atom outputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.common import (ParamTree, edge_vectors,
                                           energy_loss, gaussian_rbf,
                                           graph_readout, masked_nll,
                                           poly_cutoff, safe_edges,
                                           segment_sum, take_rows)
from repro_torch.models.sharding import shard_hint
from repro_torch.train.step import make_train_step as _train_step


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus, SchNet's activation."""
    return F.softplus(x) - math.log(2.0)


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    d_feat: int = 0          # >0: project dense node features instead
    task: str = "energy"     # "energy" | "node_class"
    n_graphs: int = 1
    n_classes: int = 0
    dtype: Any = torch.float32


def _spec(cfg: SchNetConfig) -> dict:
    D, R = cfg.d_hidden, cfg.n_rbf
    embed = (((cfg.d_feat, D), "dense") if cfg.d_feat
             else ((cfg.n_atom_types, D), 1.0))
    inter = [{"filt1": ((R, D), "dense"), "filt1_b": ((D,), "zeros"),
              "filt2": ((D, D), "dense"), "filt2_b": ((D,), "zeros"),
              "in_w": ((D, D), "dense"),
              "out1": ((D, D), "dense"), "out1_b": ((D,), "zeros"),
              "out2": ((D, D), "dense"), "out2_b": ((D,), "zeros")}
             for _ in range(cfg.n_interactions)]
    d_out = cfg.n_classes if cfg.task == "node_class" else 1
    return {"embed": embed, "inter": inter,
            "head1": ((D, D // 2), "dense"), "head1_b": ((D // 2,), "zeros"),
            "head2": ((D // 2, d_out), "dense")}


class SchNet(ParamTree):
    def __init__(self, cfg: SchNetConfig, device):
        super().__init__(_spec(cfg), device)


def init_params(cfg: SchNetConfig, generator: torch.Generator,
                device=None) -> SchNet:
    """Random weights from ``generator`` (on ``device``; ``None`` means
    cuda) with the reference's laws."""
    return SchNet(cfg, resolve_device(device)).draw(generator)


def params_from_reference(cfg: SchNetConfig, arrays: dict,
                          device=None) -> SchNet:
    """The reference's parameter tree (numpy arrays) as the port's module
    on ``device`` (``None`` means cuda)."""
    return SchNet(cfg, resolve_device(device)).load(arrays)


def forward(model: SchNet, batch: dict, cfg: SchNetConfig) -> torch.Tensor:
    """Returns per-graph energies [G] (task=energy) or node logits."""
    edges = batch["edges"]
    src, dst, _ = safe_edges(edges)
    rhat, d, m = edge_vectors(batch["positions"].to(cfg.dtype), edges)
    if cfg.d_feat:
        x = batch["node_feat"].to(cfg.dtype) @ model.embed
    else:
        x = take_rows(model.embed, batch["atom_type"].clamp_min(0).long())
    N = x.shape[0]
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)               # [E, R]
    env = (poly_cutoff(d, cfg.cutoff) * m)[:, None]
    for lp in model.inter:
        w = ssp(rbf @ lp.filt1 + lp.filt1_b) @ lp.filt2 + lp.filt2_b
        w = w * env                                            # [E, D]
        h = x @ lp.in_w
        msg = take_rows(h, src) * w                            # cfconv
        msg = shard_hint(msg, "edge_msg")
        agg = segment_sum(msg, dst, N)
        v = ssp(agg @ lp.out1 + lp.out1_b) @ lp.out2 + lp.out2_b
        x = x + v
    h = ssp(x @ model.head1 + model.head1_b) @ model.head2
    if cfg.task == "node_class":
        return h
    return graph_readout(h, batch, cfg.n_graphs)


def loss_fn(model: SchNet, batch: dict, cfg: SchNetConfig):
    out = forward(model, batch, cfg)
    if cfg.task == "node_class":
        return masked_nll(out, batch)[0], {}
    return energy_loss(out, batch)


def make_train_step(cfg: SchNetConfig, adam_cfg):
    return _train_step(loss_fn, cfg, adam_cfg)
