"""The GNN family's bundle, the port of ``src/repro/configs/gnn_common.py``.

Every GNN arch serves the four shapes: citation-style shapes
(full_graph_sm / minibatch_lg / ogb_products) are node classification over
dense features, ``molecule`` is batched per-graph energy regression. The
geometric models (SchNet/NequIP/EquiformerV2) also take positions on every
shape.  ``minibatch_lg`` is the size of a subgraph sampled by
``graphdb.sampler`` (fanout 15-10 from 1024 seeds).

Every member of the reference's bundle is ported: the config, the
optimizer config, the train step, the abstract model and inputs on the
meta device (``init_params_abstract``, ``input_specs``), the batch specs
(``(shape, dtype)`` pairs) and concrete batches, the shardings
(``_param_pspec``, ``shardings``, in the reference's tree format) and the
analytic FLOP count.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import (ArchBundle, P, ShapeSpec, dp_axes,
                                      ns, opt_state_shardings,
                                      params_spec_like, reference_specs)
from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.common import ParamTree
from repro_torch.train import optimizer as opt_mod

_TORCH_DTYPES = {np.int32: torch.int32, np.float32: torch.float32}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        {"n_nodes": 169984, "n_edges": 168960, "d_feat": 602,
         "n_classes": 41, "note": "sampled subgraph of reddit-scale graph "
                                  "(232965 nodes), fanout 15-10 x 1024 seeds"}),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
         "n_classes": 47}),
    "molecule": ShapeSpec(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128}),
}

SMOKE_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 64, "n_edges": 256, "d_feat": 24, "n_classes": 5}),
    "molecule": ShapeSpec(
        "molecule", "train", {"n_nodes": 8, "n_edges": 16, "batch": 4}),
}


def _model_class(module) -> type:
    """The parameter module a GNN model module defines."""
    return next(v for v in vars(module).values()
                if isinstance(v, type) and issubclass(v, ParamTree)
                and v.__module__ == module.__name__)


class GNNBundle(ArchBundle):
    family = "gnn"

    def __init__(self, arch_id: str, module, make_cfg: Callable,
                 smoke: bool = False, *, flops_fn: Callable):
        """make_cfg(shape_spec) -> model config; ``smoke`` picks the small
        shapes."""
        self.arch_id = arch_id
        self.module = module
        self.make_cfg = make_cfg
        self.smoke = smoke
        self.shapes = dict(SMOKE_SHAPES if smoke else GNN_SHAPES)
        self._flops_fn = flops_fn

    # ----------------------------------------------------------------- cfg
    def model_cfg(self, shape: str):
        return self.make_cfg(self.shapes[shape])

    def init_params_abstract(self, shape: str = None):
        """The model of ``shape``'s config on the meta device."""
        return _model_class(self.module)(self.model_cfg(shape),
                                         torch.device("meta"))

    def adam_cfg(self) -> opt_mod.AdamWConfig:
        return opt_mod.AdamWConfig(lr=1e-3, total_steps=10000,
                                   weight_decay=0.0)

    def make_step(self, shape: str):
        """``step(model, opt_state, batch) -> (model, opt_state,
        metrics)``."""
        return self.module.make_train_step(self.model_cfg(shape),
                                           self.adam_cfg())

    # -------------------------------------------------------------- inputs
    def needs_positions(self) -> bool:
        return self.arch_id != "gat-cora"

    @staticmethod
    def _pad512(n: int) -> int:
        """Node and edge dims padded to multiples of 512, as the
        reference pads them for its mesh (padding encoded as -1 edges /
        -1 labels / 0 masks, which every model handles)."""
        return ((n + 511) // 512) * 512

    def _batch_specs(self, shape: str) -> dict:
        """Name -> (shape, numpy dtype) of every batch array, in the
        reference's order (``host_batch`` draws them in it)."""
        d = self.shapes[shape].dims
        if shape == "molecule":
            N = self._pad512(d["n_nodes"] * d["batch"])
            E = self._pad512(d["n_edges"] * d["batch"])
            batch = {
                "atom_type": ((N,), np.int32),
                "positions": ((N, 3), np.float32),
                "edges": ((2, E), np.int32),
                "graph_ids": ((N,), np.int32),
                "energy": ((d["batch"],), np.float32),
            }
            if self.arch_id == "gat-cora":
                batch.pop("positions")
                batch["labels"] = ((N,), np.int32)
                batch.pop("energy")
            return batch
        N, E = self._pad512(d["n_nodes"]), self._pad512(d["n_edges"])
        batch = {
            "node_feat": ((N, d["d_feat"]), np.float32),
            "edges": ((2, E), np.int32),
            "labels": ((N,), np.int32),
            "train_mask": ((N,), np.float32),
        }
        if self.needs_positions():
            batch["positions"] = ((N, 3), np.float32)
        return batch

    def input_specs(self, shape: str):
        """(model, opt_state, batch) on the meta device."""
        model = self.init_params_abstract(shape)
        batch = {k: torch.empty(shp, dtype=_TORCH_DTYPES[dt], device="meta")
                 for k, (shp, dt) in self._batch_specs(shape).items()}
        return (model, self.abstract_adam_state(model), batch)

    # ------------------------------------------------------------ shardings
    def _param_pspec(self, path, leaf):
        name = "/".join(path)
        nd = len(leaf.shape)
        if "so2" in name and nd == 2:       # EquiformerV2 SO(2) mixings
            return P(None, "model")
        if "ffn1" in name and nd == 2:
            return P(None, "model")
        return P(*([None] * nd))

    def shardings(self, mesh, shape: str):
        dp = dp_axes(mesh)
        model = self.init_params_abstract(shape)
        params, ost = reference_specs(
            (model, self.abstract_adam_state(model)))
        pshard = params_spec_like(
            params, lambda path, leaf: ns(mesh, *self._param_pspec(path, leaf)))
        oshard = opt_state_shardings(mesh, pshard, ost)

        bspec = {}
        for k, (shp, _) in self._batch_specs(shape).items():
            if k == "edges":
                bspec[k] = ns(mesh, None, dp)
            elif k == "energy":
                bspec[k] = ns(mesh, dp)
            else:
                bspec[k] = ns(mesh, dp, *([None] * (len(shp) - 1)))
        hints = {
            "edge_msg": ns(mesh, dp),
            "node_hidden": ns(mesh, dp),
        }
        in_sh = (pshard, oshard, bspec)
        out_sh = (pshard, oshard, None)
        return in_sh, out_sh, hints

    # ------------------------------------------------------------- concrete
    def host_batch(self, shape: str, seed: int = 0) -> dict:
        """The reference's concrete batch of ``shape`` as numpy arrays
        (the same law and draw order, so the same arrays)."""
        rng = np.random.default_rng(seed)
        specs = self._batch_specs(shape)
        d = self.shapes[shape].dims
        n_real = d["n_nodes"] * d.get("batch", 1) if shape == "molecule" \
            else d["n_nodes"]
        e_real = d["n_edges"] * d.get("batch", 1) if shape == "molecule" \
            else d["n_edges"]
        batch = {}
        for k, (shp, dtype) in specs.items():
            if k == "edges":
                arr = np.full(shp, -1, np.int32)
                if shape == "molecule":
                    g = np.repeat(np.arange(d["batch"]), d["n_edges"])
                    vals = (rng.integers(0, d["n_nodes"], size=(2, e_real))
                            + g[None] * d["n_nodes"])
                else:
                    vals = rng.integers(0, n_real, size=(2, e_real))
                arr[:, :e_real] = vals
            elif k == "graph_ids":
                arr = np.full(shp, -1, np.int32)
                arr[:n_real] = np.repeat(np.arange(d["batch"]), d["n_nodes"])
            elif k == "labels":
                arr = np.full(shp, -1, np.int32)
                arr[:n_real] = rng.integers(0, max(d.get("n_classes", 16), 2),
                                            size=n_real)
            elif k == "atom_type":
                arr = rng.integers(0, 10, size=shp).astype(np.int32)
            elif k == "train_mask":
                arr = np.zeros(shp, np.float32)
                arr[:n_real] = (rng.random(n_real) < 0.5)
            else:
                arr = rng.normal(size=shp).astype(np.float32)
            batch[k] = arr
        return batch

    def make_concrete(self, shape: str, seed: int = 0, device=None):
        """(model, opt_state, batch) on ``device`` (``None`` means cuda):
        weights drawn from a ``torch.Generator`` seeded with ``seed``,
        the batch from ``host_batch``."""
        dev = resolve_device(device)
        cfg = self.model_cfg(shape)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = self.module.init_params(cfg, gen, device=dev)
        ost = opt_mod.init(self.adam_cfg(), model.parameters())
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in self.host_batch(shape, seed).items()}
        return model, ost, batch

    def model_flops(self, shape: str) -> float:
        """The reference's analytic fwd+bwd FLOP count of one step."""
        return self._flops_fn(self.model_cfg(shape), self.shapes[shape])
