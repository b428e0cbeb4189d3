"""Wide & Deep (Cheng et al., arXiv:1606.07792), the port of
``src/repro/models/recsys.py``: the serve (pointwise CTR logits) and
retrieval (one query against many candidates) forward passes, and the
training step (``loss_fn``, ``make_train_step``).

The bag lookups of the deep tower go through the hand-written CUDA
embedding-bag kernel (``kernels/embedding_bag``): one launch per forward
for all ``B * n_sparse`` bags, writing the sums straight into the MLP's
input buffer (no concat copy); in training the table's gradient comes from
the kernel's backward, one launch per step (``MLPInput``).  The MLP, the
wide part and the retrieval scoring stay ``torch.matmul`` and plain
gathers in fp32, as the reference left them to XLA outside any Pallas
kernel (with TF32 off, the PyTorch default, so the card agrees with the
CPU).

Parameters live in an ``nn.Module`` under the reference's tree names
(``params_from_reference`` copies a JAX tree over), in ``cfg.dtype``; the
reference keeps fp32 masters and casts them to ``cfg.dtype`` at use, which
is the same numbers.  They are made without ``requires_grad`` (serving
builds no graph); the train step turns it on.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.embedding_bag.ops import dense_rows
from repro_torch.kernels.embedding_bag.ops import embedding_bag as bag_sum
from repro_torch.kernels.embedding_bag.ops import \
    embedding_bag_backward as bag_grad
from repro_torch.models.common import dense_init, dense_init_, resolve_device
from repro_torch.models.sharding import shard_hint


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    mlp: tuple[int, ...] = (1024, 512, 256)
    n_dense: int = 13
    max_bag: int = 8                 # multi-hot bag size per field
    # per-field vocabulary sizes (production-skewed mix)
    vocab_sizes: tuple[int, ...] = ()
    wide_vocab: int = 1_000_000
    n_wide: int = 80
    # retrieval head
    n_items: int = 1_000_000
    item_dim: int = 256
    dtype: Any = torch.float32

    def __post_init__(self):
        if not self.vocab_sizes:
            sizes = ([50_000_000] * 2 + [1_000_000] * 6 + [100_000] * 12
                     + [10_000] * 20)
            object.__setattr__(self, "vocab_sizes",
                               tuple(sizes[:self.n_sparse]))
        if len(self.vocab_sizes) != self.n_sparse:
            raise ValueError(f"{len(self.vocab_sizes)} vocab sizes for "
                             f"{self.n_sparse} sparse fields")

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)

    def field_offsets(self) -> np.ndarray:
        return np.cumsum([0] + list(self.vocab_sizes))[:-1].astype(np.int64)

    def param_count(self) -> int:
        deep_in = self.n_sparse * self.embed_dim + self.n_dense
        mlp = 0
        prev = deep_in
        for h in self.mlp:
            mlp += prev * h + h
            prev = h
        return (self.total_rows * self.embed_dim + self.wide_vocab
                + mlp + prev + self.n_items * self.item_dim
                + prev * self.item_dim)


def _param(shape, dtype, device) -> nn.Parameter:
    """Uninitialised, without ``requires_grad``: the train step
    (``train/step.py``) turns it on for the parameters it differentiates."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """One MLP layer: ``w [in, out]``, ``b [out]``."""

    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__()
        self.w = _param((n_in, n_out), dtype, device)
        self.b = _param((n_out,), dtype, device)


class WideDeep(nn.Module):
    """The parameter tree (uninitialised: ``init_params`` or
    ``params_from_reference`` fill it), plus the per-field row offsets
    into the concatenated ``table`` as a device buffer."""

    def __init__(self, cfg: WideDeepConfig, device):
        super().__init__()
        dt = cfg.dtype
        prev = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        self.table = _param((cfg.total_rows, cfg.embed_dim), dt, device)
        self.wide = _param((cfg.wide_vocab,), dt, device)
        self.wide_b = _param((), dt, device)
        layers = []
        for h in cfg.mlp:
            layers.append(Dense(prev, h, dt, device))
            prev = h
        self.mlp = nn.ModuleList(layers)
        self.out_w = _param((prev, 1), dt, device)
        self.items = _param((cfg.n_items, cfg.item_dim), dt, device)
        self.user_proj = _param((prev, cfg.item_dim), dt, device)
        self.register_buffer("offsets", torch.as_tensor(
            cfg.field_offsets(), device=device), persistent=False)

    def reference_tree(self) -> dict:
        """The parameters in the reference's tree (``mlp`` a list of
        ``{"w", "b"}``)."""
        return {"table": self.table, "wide": self.wide,
                "wide_b": self.wide_b,
                "mlp": [{"w": layer.w, "b": layer.b} for layer in self.mlp],
                "out_w": self.out_w, "items": self.items,
                "user_proj": self.user_proj}


@torch.no_grad()
def init_params(cfg: WideDeepConfig, generator: torch.Generator,
                device=None) -> WideDeep:
    """Random weights drawn from ``generator`` (on ``device``) with the
    reference's laws: truncated-normal fan-in matrices, the table and the
    wide weights at scale 0.01, the items at 0.05, zero biases.  A float32
    parameter is drawn in place, so the table is never held twice.
    ``device=None`` means cuda."""
    dev = resolve_device(device)
    model = WideDeep(cfg, dev)

    def draw(p, scale=None):
        if p.dtype == torch.float32:
            dense_init_(p, generator, scale)
        else:
            p.copy_(dense_init(tuple(p.shape), generator, scale,
                               device=dev))

    draw(model.table, 0.01)
    draw(model.wide, 0.01)
    model.wide_b.zero_()
    for layer in model.mlp:
        draw(layer.w)
        layer.b.zero_()
    draw(model.out_w)
    draw(model.items, 0.05)
    draw(model.user_proj)
    return model


@torch.no_grad()
def params_from_reference(cfg: WideDeepConfig, arrays: dict,
                          device=None) -> WideDeep:
    """The reference's parameter tree (``table``, ``wide``, ``wide_b``,
    ``mlp`` as a list of ``{"w", "b"}``, ``out_w``, ``items``,
    ``user_proj``; numpy arrays) as the port's module on ``device``
    (``None`` means cuda)."""
    model = WideDeep(cfg, resolve_device(device))
    if len(arrays["mlp"]) != len(model.mlp):
        raise ValueError(f"{len(arrays['mlp'])} reference MLP layers, "
                         f"config has {len(model.mlp)}")

    def put(p, a):
        a = np.asarray(a, dtype=np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"shape {a.shape}, port {tuple(p.shape)}")
        p.copy_(torch.tensor(a))

    for n in ("table", "wide", "wide_b", "out_w", "items", "user_proj"):
        put(getattr(model, n), arrays[n])
    for layer, lp in zip(model.mlp, arrays["mlp"]):
        put(layer.w, lp["w"])
        put(layer.b, lp["b"])
    return model


def table_ids(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """ids ``[B, F, bag]`` (-1 pad, per-field local ids) -> the ``B * F``
    bags' table rows, int32 ``[B * F, bag]``: the field offsets added where
    ``ids >= 0`` (the sums stay within int32: the largest row is
    ``total_rows - 1``)."""
    B, F_, L = ids.shape
    gidx = torch.where(ids >= 0, ids + offsets[None, :, None].to(ids.dtype),
                       -1).to(torch.int32)
    return gidx.reshape(B * F_, L).contiguous()


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """ids ``[B, F, bag]`` -> ``[B, F*dim]``: all ``B * F`` bags of
    ``table_ids`` go through one embedding-bag kernel call.  ``out``: a
    ``[B, F*dim]`` view (last stride 1, any row stride) the bags are
    written into and which is returned."""
    B, F_, _ = ids.shape
    bags = bag_sum(table_ids(ids, offsets), table, out=out)
    return bags.reshape(B, F_ * table.shape[1])


def mlp_input_width(cfg: WideDeepConfig) -> int:
    """Columns of the deep tower's input buffer: the ``F*dim`` bag sums and
    the ``n_dense`` features, rounded up to whole 16-byte pieces so that
    every row starts 16-byte aligned (K4's ``vec`` route writes into it);
    1,293 fp32 columns become 1,296 at ``CONFIG``."""
    per_piece = 16 // cfg.dtype.itemsize
    n_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    return -(-n_in // per_piece) * per_piece


class MLPInput(torch.autograd.Function):
    """The deep tower's input, the reference's concat ``[bags, dense]``,
    built in place: ``apply(table, gidx, dense, width)`` (``gidx`` from
    ``table_ids``) has K4 write the ``B * F`` bag sums straight into
    columns ``[0, F*dim)`` of one ``[B, width]`` buffer, copies ``dense``
    beside them and returns the ``[B, F*dim + n_dense]`` view (the padding
    columns are never read).  Backward: the table's gradient from the first
    ``F*dim`` columns of the incoming gradient, through K4's backward
    (``dense`` and the ids take none)."""

    @staticmethod
    def forward(ctx, table, gidx, dense, width):
        B = dense.shape[0]
        n_bags = gidx.shape[0] // max(B, 1) * table.shape[1]
        n_in = n_bags + dense.shape[1]
        buf = torch.empty((B, width), dtype=table.dtype, device=table.device)
        bag_sum(gidx, table, out=buf[:, :n_bags])
        buf[:, n_bags:n_in] = dense
        ctx.save_for_backward(gidx)
        ctx.rows, ctx.n_bags, ctx.dtype = table.shape[0], n_bags, table.dtype
        return buf[:, :n_in]

    @staticmethod
    def backward(ctx, grad):
        (gidx,) = ctx.saved_tensors
        g = bag_grad(gidx, dense_rows(grad[:, :ctx.n_bags].float()),
                     ctx.rows)
        return g.to(ctx.dtype), None, None, None


def deep_tower(model: WideDeep, batch: dict,
               cfg: WideDeepConfig) -> torch.Tensor:
    """The reference's concat ``[bags, dense]`` (``MLPInput``: no concat
    copy) and MLP; the first layer multiplies the buffer's ``[B, F*dim +
    n_dense]`` view, whose row stride is cuBLAS's leading dimension."""
    x = MLPInput.apply(model.table,
                       table_ids(batch["sparse_ids"], model.offsets),
                       batch["dense"].to(cfg.dtype), mlp_input_width(cfg))
    # the bags are the buffer's first columns (the reference's [B, F, dim])
    shard_hint(x[:, :cfg.n_sparse * cfg.embed_dim], "bag_emb")
    for layer in model.mlp:
        x = torch.relu(x @ layer.w + layer.b)
        x = shard_hint(x, "mlp_hidden")
    return x                                            # [B, mlp[-1]]


def forward(model: WideDeep, batch: dict, cfg: WideDeepConfig) -> torch.Tensor:
    """Pointwise CTR logits ``[B]``."""
    deep = deep_tower(model, batch, cfg) @ model.out_w
    wide_ids = batch["wide_ids"]
    wvals = model.wide[wide_ids.clamp(min=0).to(torch.int64)]
    wide = (wvals * (wide_ids >= 0)).sum(dim=-1) + model.wide_b
    return deep[:, 0] + wide


def retrieval_scores(model: WideDeep, batch: dict,
                     cfg: WideDeepConfig) -> torch.Tensor:
    """One query against ``candidate_ids [n_cand]`` -> scores ``[n_cand]``."""
    user = deep_tower(model, batch, cfg) @ model.user_proj   # [1, item_dim]
    cand = model.items.index_select(
        0, batch["candidate_ids"].to(torch.int64))      # [n_cand, item_dim]
    cand = shard_hint(cand, "cand_emb")
    return cand @ user[0]


def loss_fn(model: WideDeep, batch: dict, cfg: WideDeepConfig):
    """The reference's binary cross-entropy with logits, in its stable form
    ``max(z, 0) - z y + log1p(exp(-|z|))``, averaged over the batch; returns
    (loss, {"acc"}), ``acc`` the share of logits on the label's side of 0."""
    logits = forward(model, batch, cfg).to(torch.float32)
    y = batch["labels"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"acc": acc}


def make_train_step(cfg: WideDeepConfig, adam_cfg):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``repro_torch.train.step``'s step over ``loss_fn`` (the
    bounded AdamW update, so the full table's gradient and moments fit
    beside it).  Float32 configs only."""
    from repro_torch.train.step import make_train_step as train_step
    if cfg.dtype != torch.float32:
        raise ValueError(f"make_train_step: {cfg.name} computes in "
                         f"{cfg.dtype}; the port trains float32 configs "
                         f"only")
    return train_step(loss_fn, cfg, adam_cfg)


def synthetic_batch(cfg: WideDeepConfig, batch_size: int, seed: int = 0,
                    with_labels: bool = True) -> dict:
    """Host-side synthetic click-log batch (skewed ids, learnable signal)."""
    rng = np.random.default_rng(seed)
    ids = np.empty((batch_size, cfg.n_sparse, cfg.max_bag), np.int32)
    for f, v in enumerate(cfg.vocab_sizes):
        z = rng.zipf(1.2, size=(batch_size, cfg.max_bag)).astype(np.int64)
        ids[:, f] = (z - 1) % v
    nbag = rng.integers(1, cfg.max_bag + 1, size=(batch_size, cfg.n_sparse))
    mask = np.arange(cfg.max_bag)[None, None] < nbag[..., None]
    ids = np.where(mask, ids, -1)
    dense = rng.normal(size=(batch_size, cfg.n_dense)).astype(np.float32)
    wide = rng.integers(0, cfg.wide_vocab,
                        size=(batch_size, cfg.n_wide)).astype(np.int32)
    out = {"sparse_ids": ids, "dense": dense, "wide_ids": wide}
    if with_labels:
        # label depends on dense features + a few id parities -> learnable
        sig = dense[:, 0] + 0.5 * dense[:, 1] + 0.3 * (ids[:, 0, 0] % 2)
        out["labels"] = (sig > 0.4).astype(np.float32)
    return out
