"""NequIP (Batzner et al., arXiv:2101.03164), the port of
``src/repro/models/gnn/nequip.py``: an E(3)-equivariant interatomic
potential by Clebsch-Gordan tensor-product message passing.

Features are C channels of every irrep l<=l_max, stored flat as
``[N, C, (l_max+1)^2]``.  Each interaction block computes, per valid path
(l1 x l2 -> l3), messages ``w_path(d_ij) * CG(f_j^{l1}, Y^{l2}(r_ij))``
aggregated by a segment sum.  Where the reference adds into and scales
slices of a tensor (``.at[...].add / set / multiply``), the port builds
new tensors (``torch.cat`` of the blocks, a 0/1 matmul that adds each
path's output into its l3 block), so no tensor that autograd saved is
written in place.  The paths from one l1 share one batched matmul.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.common import (ParamTree, bessel_rbf,
                                           edge_vectors, energy_loss,
                                           graph_readout, masked_nll,
                                           poly_cutoff, safe_edges,
                                           segment_sum, take_rows)
from repro_torch.models.gnn.irreps import (cg_tensor, irrep_slices,
                                           real_sph_harm)
from repro_torch.models.sharding import shard_hint
from repro_torch.train.step import make_train_step as _train_step


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_atom_types: int = 100
    d_feat: int = 0
    avg_neighbors: float = 10.0
    task: str = "energy"
    n_graphs: int = 1
    n_classes: int = 0
    dtype: Any = torch.float32

    def paths(self) -> list[tuple[int, int, int]]:
        out = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(self.l_max + 1):
                    if abs(l1 - l2) <= l3 <= l1 + l2:
                        out.append((l1, l2, l3))
        return out

    @property
    def dim(self) -> int:
        return (self.l_max + 1) ** 2


def _spec(cfg: NequIPConfig) -> dict:
    C, R = cfg.d_hidden, cfg.n_rbf
    npaths = len(cfg.paths())
    embed = (((cfg.d_feat, C), "dense") if cfg.d_feat
             else ((cfg.n_atom_types, C), 1.0))
    layers = [{"rad1": ((R, 32), "dense"), "rad1_b": ((32,), "zeros"),
               "rad2": ((32, npaths * C), "dense"),
               # per-l channel mixings (self-interaction before/after conv)
               "mix_pre": ((cfg.l_max + 1, C, C), "dense"),
               "mix_post": ((cfg.l_max + 1, C, C), "dense"),
               "gate_w": ((C, cfg.l_max * C), "dense"),
               "gate_b": ((cfg.l_max * C,), "zeros")}
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers,
            "head1": ((C, C), "dense"), "head1_b": ((C,), "zeros"),
            "head2": ((C, cfg.n_classes if cfg.task == "node_class" else 1),
                      "dense")}


class NequIP(ParamTree):
    def __init__(self, cfg: NequIPConfig, device):
        super().__init__(_spec(cfg), device)


def init_params(cfg: NequIPConfig, generator: torch.Generator,
                device=None) -> NequIP:
    """Random weights from ``generator`` (on ``device``; ``None`` means
    cuda) with the reference's laws."""
    return NequIP(cfg, resolve_device(device)).draw(generator)


def params_from_reference(cfg: NequIPConfig, arrays: dict,
                          device=None) -> NequIP:
    """The reference's parameter tree (numpy arrays) as the port's module
    on ``device`` (``None`` means cuda)."""
    return NequIP(cfg, resolve_device(device)).load(arrays)


def per_l_mix(x: torch.Tensor, w: torch.Tensor, slices) -> torch.Tensor:
    """x [N, C, dim]; w [L+1, C, C] -> per-l channel mixing."""
    return torch.cat([torch.einsum("ncm,cd->ndm", x[..., sl], w[l])
                      for l, sl in enumerate(slices)], dim=-1)


def gate(agg: torch.Tensor, gate_w: torch.Tensor, gate_b: torch.Tensor,
         slices) -> torch.Tensor:
    """The gated nonlinearity: the scalars through silu, each l>0 block
    scaled by a sigmoid gate of the scalars (``[N, C, dim]``)."""
    N, C, _ = agg.shape
    l_max = len(slices) - 1
    gates = torch.sigmoid(agg[..., 0] @ gate_w + gate_b)
    gates = gates.reshape(N, l_max, C).transpose(1, 2)        # [N, C, l_max]
    return torch.cat([F.silu(agg[..., :1])]
                     + [agg[..., slices[l]] * gates[..., l - 1, None]
                        for l in range(1, l_max + 1)], dim=-1)


def embed_scalars(model, batch: dict, cfg, N: int) -> torch.Tensor:
    """``[N, C, dim]`` features: the embedding in the l=0 slot, zeros
    elsewhere."""
    if cfg.d_feat:
        s0 = batch["node_feat"].to(cfg.dtype) @ model.embed
    else:
        at = batch.get("atom_type")
        if at is None:
            at = torch.zeros(N, dtype=torch.long, device=model.embed.device)
        s0 = take_rows(model.embed, at.clamp_min(0).long())
    return torch.cat([s0[..., None],
                      s0.new_zeros(s0.shape + (cfg.dim - 1,))], dim=-1)


def _path_tables(cfg: NequIPConfig, Y: torch.Tensor, slices):
    """The tensor product's tables for one batch.  Per l1, the CG tensor
    of every path from l1 (``paths()`` lists them by l1) contracted with
    the edges' ``Y^{l2}``, stacked: ``[E, sum of 2l3+1, 2l1+1]``; the path
    of each output column; and the 0/1 ``[columns, dim]`` map that adds
    each path's columns into its l3 block (the reference's
    ``msg.at[..., l3].add``)."""
    dev, dt = Y.device, cfg.dtype
    CY, col_path = [], []
    S = np.zeros((sum(2 * p[2] + 1 for p in cfg.paths()), cfg.dim))
    for l1 in range(cfg.l_max + 1):
        blocks = []
        for pi, (a, l2, l3) in enumerate(cfg.paths()):
            if a != l1:
                continue
            cg = torch.as_tensor(cg_tensor(a, l2, l3), dtype=dt, device=dev)
            blocks.append(torch.einsum("kij,ej->eki", cg, Y[..., slices[l2]]))
            for k in range(2 * l3 + 1):
                S[len(col_path), l3 * l3 + k] = 1.0
                col_path.append(pi)
        CY.append(torch.cat(blocks, dim=1))
    return (CY, torch.as_tensor(col_path, device=dev),
            torch.as_tensor(S, dtype=dt, device=dev))


def forward(model: NequIP, batch: dict, cfg: NequIPConfig) -> torch.Tensor:
    edges = batch["edges"]
    src, dst, _ = safe_edges(edges)
    rhat, d, m = edge_vectors(batch["positions"].to(cfg.dtype), edges)
    N = batch["positions"].shape[0]
    C = cfg.d_hidden
    slices = irrep_slices(cfg.l_max)
    paths = cfg.paths()
    x = embed_scalars(model, batch, cfg, N)
    Y = real_sph_harm(cfg.l_max, rhat).to(cfg.dtype)           # [E, dim]
    CY, col_path, S = _path_tables(cfg, Y, slices)
    rbf = bessel_rbf(d, cfg.n_rbf, cfg.cutoff)
    env = (poly_cutoff(d, cfg.cutoff) * m)[:, None]

    for lp in model.layers:
        rad = F.silu(rbf @ lp.rad1 + lp.rad1_b) @ lp.rad2
        rad = rad.reshape(-1, len(paths), C) * env[..., None]  # [E, P, C]
        h = per_l_mix(x, lp.mix_pre, slices)
        hs = take_rows(h, src)                                 # [E, C, dim]
        hs = shard_hint(hs, "edge_msg")
        # every path's CG(f^{l1}, Y^{l2}) as one output column block
        t = torch.cat([torch.einsum("eci,eki->eck", hs[..., slices[l1]], cy)
                       for l1, cy in enumerate(CY)], dim=-1)
        t = t * torch.index_select(rad, 1, col_path).transpose(1, 2)
        msg = t @ S                                            # [E, C, dim]
        agg = segment_sum(msg, dst, N)
        agg = agg / math.sqrt(cfg.avg_neighbors)
        agg = per_l_mix(agg, lp.mix_post, slices)
        x = x + gate(agg, lp.gate_w, lp.gate_b, slices)
    h = F.silu(x[..., 0] @ model.head1 + model.head1_b)
    h = h @ model.head2
    if cfg.task == "node_class":
        return h
    return graph_readout(h, batch, cfg.n_graphs)


def loss_fn(model: NequIP, batch: dict, cfg: NequIPConfig):
    out = forward(model, batch, cfg)
    if cfg.task == "node_class":
        return masked_nll(out, batch)[0], {}
    return energy_loss(out, batch)


def make_train_step(cfg: NequIPConfig, adam_cfg):
    return _train_step(loss_fn, cfg, adam_cfg)
