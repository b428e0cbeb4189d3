"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim 32,
MLP 1024-512-256, concat interaction.

The reference's ``RecsysBundle`` (``bundle()``), built over this
module's functions: ``make_step`` (the step callable of a shape kind:
train, serve or retrieval), ``adam_cfg``, ``host_batch``/``make_batch``
(the batch half of ``make_concrete``), ``make_concrete`` and
``model_flops``; the bundle adds the abstract model and inputs on the meta
device and the shardings in the reference's tree format.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (ArchBundle, P, ShapeSpec, dp_axes,
                                      ns, opt_state_shardings,
                                      params_spec_like, reference_specs)
from repro_torch.models import recsys
from repro_torch.models.common import resolve_device
from repro_torch.train import optimizer as opt

SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1_000_000}),
}

SMOKE_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 64}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 16}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 512}),
}

CONFIG = recsys.WideDeepConfig()
SMOKE = recsys.WideDeepConfig(name="wide-deep-smoke",
                              vocab_sizes=tuple([512] * 40),
                              wide_vocab=1024, n_items=512, item_dim=32,
                              mlp=(64, 32, 16))


def adam_cfg() -> opt.AdamWConfig:
    """The reference's optimizer for Wide & Deep: lr 1e-3, no weight
    decay, 100,000 steps (warm-up 100, clipping at 1.0 by default)."""
    return opt.AdamWConfig(lr=1e-3, total_steps=100000, weight_decay=0.0)


def make_step(cfg: recsys.WideDeepConfig, kind: str):
    """The step of a shape kind: ``train_step(model, opt_state, batch)``
    (``recsys.make_train_step`` with ``adam_cfg()``), or ``step(model,
    batch)`` of a serve or retrieval shape."""
    if kind == "train":
        return recsys.make_train_step(cfg, adam_cfg())
    if kind == "serve":
        return lambda model, batch: recsys.forward(model, batch, cfg)
    if kind == "retrieval":
        return lambda model, batch: recsys.retrieval_scores(model, batch,
                                                            cfg)
    raise ValueError(f"shape kind {kind!r}: not train, serve or retrieval")


def host_batch(cfg: recsys.WideDeepConfig, shape: ShapeSpec,
               seed: int = 0) -> dict:
    """The reference's concrete batch of ``shape`` as numpy arrays:
    ``synthetic_batch`` (labels only for training), and for retrieval the
    candidate ids in place of the wide ids."""
    d = shape.dims
    batch = recsys.synthetic_batch(cfg, d["batch"], seed=seed,
                                   with_labels=(shape.kind == "train"))
    if shape.kind == "retrieval":
        batch.pop("wide_ids")
        rng = np.random.default_rng(seed)
        batch["candidate_ids"] = rng.integers(
            0, cfg.n_items, size=d["n_candidates"]).astype(np.int32)
    return batch


def make_batch(cfg: recsys.WideDeepConfig, shape: ShapeSpec, seed: int = 0,
               device=None) -> dict:
    """``host_batch`` as tensors on ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev)
            for k, v in host_batch(cfg, shape, seed).items()}


def make_concrete(cfg: recsys.WideDeepConfig, shape: ShapeSpec,
                  seed: int = 0, device=None) -> tuple:
    """The reference's ``make_concrete`` on ``device`` (``None`` means
    cuda): weights drawn from a ``torch.Generator`` seeded with ``seed``
    (``recsys.init_params``), ``make_batch``'s batch, and for a train shape
    the AdamW state of ``adam_cfg()`` between them: ``(model, opt_state,
    batch)``, else ``(model, batch)``."""
    dev = resolve_device(device)
    model = recsys.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = make_batch(cfg, shape, seed, dev)
    if shape.kind == "train":
        return model, opt.init(adam_cfg(), model.parameters()), batch
    return model, batch


def model_flops(cfg: recsys.WideDeepConfig, shape: ShapeSpec) -> float:
    d = shape.dims
    B = d["batch"]
    deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    mlp = 0
    prev = deep_in
    for h in cfg.mlp:
        mlp += 2 * prev * h
        prev = h
    bag = cfg.n_sparse * cfg.max_bag * cfg.embed_dim
    fwd = B * (mlp + bag)
    if shape.kind == "train":
        return 3.0 * fwd
    if shape.kind == "retrieval":
        return fwd + 2.0 * d["n_candidates"] * cfg.item_dim
    return float(fwd)


class RecsysBundle(ArchBundle):
    family = "recsys"
    arch_id = "wide-deep"

    def __init__(self, smoke: bool = False):
        self.smoke = smoke
        self.cfg = SMOKE if smoke else CONFIG
        self.shapes = dict(SMOKE_SHAPES if smoke else SHAPES)

    def init_params_abstract(self) -> recsys.WideDeep:
        return recsys.WideDeep(self.cfg, torch.device("meta"))

    def adam_cfg(self) -> opt.AdamWConfig:
        return adam_cfg()

    def make_step(self, shape: str):
        return make_step(self.cfg, self.shapes[shape].kind)

    def _batch_specs(self, shape: str) -> dict:
        """Name -> (shape, dtype) of every batch tensor."""
        d = self.shapes[shape].dims
        B = d["batch"]
        cfg = self.cfg
        base = {
            "sparse_ids": ((B, cfg.n_sparse, cfg.max_bag), torch.int32),
            "dense": ((B, cfg.n_dense), torch.float32),
        }
        kind = self.shapes[shape].kind
        if kind == "retrieval":
            base["candidate_ids"] = ((d["n_candidates"],), torch.int32)
            return base
        base["wide_ids"] = ((B, cfg.n_wide), torch.int32)
        if kind == "train":
            base["labels"] = ((B,), torch.float32)
        return base

    def input_specs(self, shape: str):
        """The step's arguments on the meta device."""
        model = self.init_params_abstract()
        batch = {k: torch.empty(shp, dtype=dt, device="meta")
                 for k, (shp, dt) in self._batch_specs(shape).items()}
        if self.shapes[shape].kind == "train":
            return (model, self.abstract_adam_state(model), batch)
        return (model, batch)

    def _param_pspec(self, path, leaf):
        name = "/".join(path)
        nd = len(leaf.shape)
        if "table" in name or "items" in name:
            return P("model", None)
        if name.endswith("('wide',)") or "wide'" in name:
            return P("model") if nd == 1 else P(*([None] * nd))
        return P(*([None] * nd))

    def shardings(self, mesh, shape: str):
        dp = dp_axes(mesh)
        model = self.init_params_abstract()
        params = reference_specs((model,))[0]
        pshard = params_spec_like(
            params, lambda p, l: ns(mesh, *self._param_pspec(p, l)))
        kind = self.shapes[shape].kind
        bspec = {}
        B = self.shapes[shape].dims["batch"]
        for k, (shp, _) in self._batch_specs(shape).items():
            if k == "candidate_ids":
                bspec[k] = ns(mesh, dp)
            elif B == 1:       # retrieval: a single query is replicated
                bspec[k] = ns(mesh, *([None] * len(shp)))
            else:
                bspec[k] = ns(mesh, dp, *([None] * (len(shp) - 1)))
        hints = {"bag_emb": ns(mesh, dp),
                 "mlp_hidden": ns(mesh, dp),
                 "cand_emb": ns(mesh, dp, None)}
        if kind == "train":
            ost = reference_specs((model, self.abstract_adam_state(model)))[1]
            oshard = opt_state_shardings(mesh, pshard, ost)
            return ((pshard, oshard, bspec), (pshard, oshard, None), hints)
        return ((pshard, bspec), ns(mesh, dp), hints)

    def make_concrete(self, shape: str, seed: int = 0, device=None):
        """``make_concrete`` of this bundle's config (``None`` means
        cuda)."""
        return make_concrete(self.cfg, self.shapes[shape], seed, device)

    def model_flops(self, shape: str) -> float:
        return model_flops(self.cfg, self.shapes[shape])


def bundle(smoke: bool = False) -> RecsysBundle:
    return RecsysBundle(smoke=smoke)
