"""EquiformerV2 (Liao et al., arXiv:2306.12059), the port of
``src/repro/models/gnn/equiformer_v2.py``: equivariant graph attention with
eSCN SO(2) convolutions.

Each edge's features are rotated into a frame where the edge direction is
+z (``irreps.edge_wigner``); there the SH filters are diagonal in m, so
the tensor product collapses to dense SO(2) mixings per |m| <= m_max.
Same reductions as the reference: a gate nonlinearity, radial scaling per
l, single-hop attention logits from the m=0 stream.

Each layer runs under ``torch.utils.checkpoint`` (the reference's
per-layer ``jax.checkpoint``), so the backward holds one layer's edge
tensors at a time.  Inside a layer the messages take one of the
reference's three paths, chosen by its own rule (``_path``):

- the default: every edge at once, a segment softmax over the N
  destinations;
- ``node_chunks`` (wins when both are set): the caller has binned the
  edges by destination range, ``E / nch`` edges a chunk in array order,
  chunk c's targets in ``[c N/nch, (c+1) N/nch)``.  Each chunk's softmax
  and sum finish locally over its ``N / nch`` nodes, so nothing is
  carried; an edge whose destination lies outside its chunk's range is
  dropped, as in the reference;
- ``edge_chunk``: chunks of ``edge_chunk`` edges with an online segment
  softmax that carries the running max, sum and an fp32 ``[N, C, dim]``
  accumulator.  The softmax does not depend on the max it is shifted by,
  so the max carries no gradient (as in ``common.segment_softmax``).

A setting that fails its condition takes the default path, and
``bin_edges`` lays a batch out for ``node_chunks``.  Each chunk runs under
its own checkpoint, inside the layer's; the chunks reuse the precomputed
Wigner rows, radial bases and envelopes by slicing them.  The reference
stacks the layers' parameters along a leading axis for its ``lax.scan``;
the port keeps a ``ModuleList`` of layers, and ``params_from_reference``
unstacks axis 0.
The per-edge Wigner matrices depend on the geometry alone, so they are
built once per forward rather than in every layer: the rows of one
block-diagonal matrix an edge that reach the components the SO(2) mixing
keeps, so each rotation is one batched matmul.  In the edge frame the
features are ``[E, K, C]`` (kept components, then channels), so every m
block is a view and the mixing's weights are read in that order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.common import (ParamTree, edge_vectors,
                                           energy_loss, gaussian_rbf,
                                           graph_readout, masked_nll,
                                           poly_cutoff, safe_edges,
                                           segment_max, segment_softmax,
                                           segment_sum, take_rows)
from repro_torch.models.gnn.irreps import edge_wigner, irrep_slices
from repro_torch.models.gnn.nequip import embed_scalars, gate, per_l_mix
from repro_torch.models.sharding import shard_hint
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step as _train_step


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128          # channels per irrep
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 64
    cutoff: float = 8.0
    n_atom_types: int = 100
    d_feat: int = 0
    avg_neighbors: float = 20.0
    task: str = "energy"
    n_graphs: int = 1
    n_classes: int = 0
    dtype: Any = torch.float32
    # process edges in chunks with an online segment softmax, so the
    # per-edge [E, C, dim] tensors never exist at full E
    edge_chunk: int = 0
    # edges pre-binned by destination-node range (chunk c targets nodes in
    # [c*N/nch, (c+1)*N/nch)): each chunk's softmax and sum finish locally
    node_chunks: int = 0

    @property
    def dim(self) -> int:
        return (self.l_max + 1) ** 2

    def m_indices(self) -> list[tuple[np.ndarray, np.ndarray | None]]:
        """Per m in 0..m_max: (pos_idx, neg_idx|None) into the flat irrep dim,
        listing components of every l >= max(m,0)."""
        out = []
        for m in range(self.m_max + 1):
            ls = list(range(max(m, 0), self.l_max + 1)) if m == 0 else list(
                range(m, self.l_max + 1))
            pos = np.array([l * l + l + m for l in ls], dtype=np.int32)
            neg = (np.array([l * l + l - m for l in ls], dtype=np.int32)
                   if m > 0 else None)
            out.append((pos, neg))
        return out


def _spec(cfg: EquiformerV2Config) -> dict:
    C, H = cfg.d_hidden, cfg.n_heads
    embed = (((cfg.d_feat, C), "dense") if cfg.d_feat
             else ((cfg.n_atom_types, C), 1.0))
    layers = []
    for _ in range(cfg.n_layers):
        so2 = []
        for mm, (pos, _neg) in enumerate(cfg.m_indices()):
            n = len(pos) * C
            so2.append({"wr": ((n, n), "dense"), "wi": ((n, n), "dense")}
                       if mm > 0 else {"wr": ((n, n), "dense")})
        layers.append({
            "so2": so2,
            "rad1": ((cfg.n_rbf, 32), "dense"), "rad1_b": ((32,), "zeros"),
            "rad2": ((32, cfg.l_max + 1), "dense"),
            "alpha": ((C, H), "dense"),
            "mix": ((cfg.l_max + 1, C, C), "dense"),
            "ffn1": ((C, 2 * C), "dense"), "ffn1_b": ((2 * C,), "zeros"),
            "ffn2": ((2 * C, C), "dense"),
            "gate_w": ((C, cfg.l_max * C), "dense"),
            "gate_b": ((cfg.l_max * C,), "zeros"),
            "ln_scale": ((cfg.l_max + 1, C), "ones"),
        })
    return {"embed": embed, "layers": layers,
            "head1": ((C, C), "dense"), "head1_b": ((C,), "zeros"),
            "head2": ((C, cfg.n_classes if cfg.task == "node_class" else 1),
                      "dense")}


class EquiformerV2(ParamTree):
    STACKED = ("layers",)

    def __init__(self, cfg: EquiformerV2Config, device):
        super().__init__(_spec(cfg), device)


def init_params(cfg: EquiformerV2Config, generator: torch.Generator,
                device=None) -> EquiformerV2:
    """Random weights from ``generator`` (on ``device``; ``None`` means
    cuda) with the reference's laws."""
    return EquiformerV2(cfg, resolve_device(device)).draw(generator)


def _unstack(tree, i: int, n: int):
    """Entry ``i`` of every leaf of a tree stacked ``n`` deep."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstack(v, i, n) for v in tree]
    a = np.asarray(tree)
    if a.shape[:1] != (n,):
        raise ValueError(f"a layer leaf of shape {a.shape}, stacked for "
                         f"{n} layers")
    return a[i]


def params_from_reference(cfg: EquiformerV2Config, arrays: dict,
                          device=None) -> EquiformerV2:
    """The reference's parameter tree (numpy arrays, its layers stacked
    along a leading axis) as the port's module on ``device`` (``None``
    means cuda)."""
    L = cfg.n_layers
    arrays = dict(arrays, layers=[_unstack(arrays["layers"], i, L)
                                  for i in range(L)])
    return EquiformerV2(cfg, resolve_device(device)).load(arrays)


def bin_edges(edges: np.ndarray, n_nodes: int, nch: int) -> np.ndarray:
    """A padded COO batch ``[2, E]`` (-1 pads) laid out for ``node_chunks
    = nch``: the real edges grouped by destination range (``n_nodes /
    nch`` nodes a range; in their order within a range), every group
    padded with -1 edges to the fullest group's size ``cap``, so the
    result is ``[2, nch * cap]``."""
    edges = np.asarray(edges)
    if n_nodes % nch:
        raise ValueError(f"{n_nodes} nodes do not split into {nch} ranges")
    real = edges[:, (edges >= 0).all(axis=0)]
    b = real[1] // (n_nodes // nch)
    order = np.argsort(b, kind="stable")
    counts = np.bincount(b, minlength=nch)
    cap = max(int(counts.max()), 1)
    slot = np.arange(real.shape[1]) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    out = np.full((2, nch * cap), -1, dtype=edges.dtype)
    out[:, b[order] * cap + slot] = real[:, order]
    return out


def _equi_layernorm(x, scale, slices):
    """Per-l RMS over (channel, m) with learned per-channel scale."""
    outs = []
    for l, sl in enumerate(slices):
        blk = x[..., sl]
        rms = torch.sqrt(torch.mean(torch.square(blk), dim=(-1, -2),
                                    keepdim=True) + 1e-6)
        outs.append(blk / rms * scale[l][None, :, None])
    return torch.cat(outs, dim=-1)


def _so2_layout(cfg: EquiformerV2Config, device):
    """The edge-frame components the SO(2) convolution keeps (|m| <=
    m_max), in the order ``[+0 | +1, -1 | ... | +m_max, -m_max]``, each
    block listing l = |m|..l_max: their flat irrep indices and their l's
    (int64 tensors), and each m's (offset, count) in that order."""
    keep, blocks = [], []
    for m, (pos, neg) in enumerate(cfg.m_indices()):
        blocks.append((len(keep), len(pos)))
        keep.extend(pos.tolist())
        if m > 0:
            keep.extend(neg.tolist())
    keep = np.asarray(keep)
    l_of = np.floor(np.sqrt(keep)).astype(np.int64)
    return (torch.as_tensor(keep, device=device),
            torch.as_tensor(l_of, device=device), blocks)


def _edge_frames(rhat, cfg, slices, keep):
    """The rows ``keep`` of each edge's block-diagonal Wigner matrix (every
    l's ``edge_wigner`` on the diagonal): ``[E, K, dim]``, the world frame
    to the kept edge-frame components in one batched matmul."""
    D = rhat.new_zeros(rhat.shape[0], cfg.dim, cfg.dim, dtype=cfg.dtype)
    for l, sl in enumerate(slices):
        D[:, sl, sl] = edge_wigner(l, rhat).to(cfg.dtype)
    return torch.index_select(D, 1, keep)


def _so2_conv(fe, lp, blocks):
    """The SO(2) mixing per |m| <= m_max of edge-frame features ``fe [E, K,
    C]`` (kept components first, channels last).  The reference flattens
    each m's components channel-major, ``[E, C*nl]``; here a block is
    ``[E, nl*C]`` (a view of ``fe``), so its weights are taken with rows
    and columns in that order (``[C, nl, C, nl]`` -> ``[nl, C, nl, C]``):
    the same products."""
    E, K, C = fe.shape

    def mix(w, nl):
        return w.to(fe.dtype).reshape(C, nl, C, nl).permute(
            1, 0, 3, 2).reshape(nl * C, nl * C)

    parts = []
    for m, (a, nl) in enumerate(blocks):
        xp = fe[:, a:a + nl].reshape(E, nl * C)
        wr = mix(lp.so2[m].wr, nl)
        if m == 0:
            parts.append(xp @ wr)
        else:
            xn = fe[:, a + nl:a + 2 * nl].reshape(E, nl * C)
            wi = mix(lp.so2[m].wi, nl)
            parts.append(xp @ wr - xn @ wi)
            parts.append(xp @ wi + xn @ wr)
    return torch.cat(parts, dim=1).reshape(E, K, C)


def _edge_messages(xn, lp, cfg, src, Dk, rbf, env, so2):
    """Messages rotated back to the world frame (``[e, C, dim]``) and
    attention logits (``[e, H]``) of one slice of edges."""
    _, l_of, blocks = so2
    rad = F.silu(rbf.to(cfg.dtype) @ lp.rad1 + lp.rad1_b) @ lp.rad2
    rad = rad * env.to(cfg.dtype)                          # [e, l_max+1]
    # rotate into the edge frame (only the components the SO(2) mixing
    # keeps: those with |m| > m_max are dropped there), mix, scale by l
    fe = Dk @ take_rows(xn, src).transpose(1, 2)           # [e, K, C]
    fe = shard_hint(fe, "edge_msg")
    me = _so2_conv(fe, lp, blocks) * torch.index_select(rad, 1, l_of)[
        ..., None]
    logits = me[:, 0] @ lp.alpha.to(cfg.dtype)             # [e, H] (l=m=0)
    # rotate messages back to the world frame before aggregation
    return me.transpose(1, 2) @ Dk, logits                 # [e, C, dim]


def _weighted(mw, w, H):
    """Each head's channels of ``mw [e, C, dim]`` scaled by ``w [e, H]``."""
    e, C, dim = mw.shape
    return (mw.reshape(e, H, C // H, dim) * w[..., None, None]).reshape(
        e, C, dim)


def _ckpt(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint where autograd
    records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _path(cfg: EquiformerV2Config, N: int, E: int) -> tuple:
    """The reference's choice: ``("node", nch)``, ``("edge", chunk)`` or
    ``("default",)``; a setting whose condition fails takes the default."""
    if cfg.node_chunks > 1 and N % cfg.node_chunks == 0 \
            and E % cfg.node_chunks == 0:
        return ("node", cfg.node_chunks)
    if cfg.edge_chunk and E > cfg.edge_chunk and E % cfg.edge_chunk == 0:
        return ("edge", cfg.edge_chunk)
    return ("default",)


def _node_chunk(xn, lp, cfg, lo, Nc, src, dst, m, Dk, rbf, env, so2):
    """One destination range's aggregate ``[Nc, C, dim]``: the softmax in
    fp32 over the range's ``Nc`` nodes, edges aimed outside it dropped."""
    mw, logits = _edge_messages(xn, lp, cfg, src, Dk, rbf, env, so2)
    dloc = (dst - lo).clamp(0, Nc - 1)
    ok = m & (dst >= lo) & (dst < lo + Nc)
    alpha = segment_softmax(logits.float(), dloc, Nc, mask=ok[:, None])
    return segment_sum(_weighted(mw, alpha.to(mw.dtype), cfg.n_heads),
                       dloc, Nc)


def _edge_chunk(mx, lsum, acc, xn, lp, cfg, src, dst, m, Dk, rbf, env,
                so2):
    """One step of the online segment softmax: the running max ``mx`` and
    sum ``lsum`` ``[N, H]`` and the fp32 accumulator ``acc [N, C, dim]``
    after one more chunk of edges.  A destination with no edge in the
    chunk has max ``-inf`` there (``segment_max``), so its max stays."""
    N, C, _ = acc.shape
    H = cfg.n_heads
    mw, logits = _edge_messages(xn, lp, cfg, src, Dk, rbf, env, so2)
    logits = torch.where(m[:, None], logits.float(), -1e30)
    with torch.no_grad():
        mx_new = torch.maximum(mx, segment_max(logits, dst, N))
    corr = torch.exp(mx - mx_new)                          # [N, H]
    p = torch.where(m[:, None], torch.exp(logits - take_rows(mx_new, dst)),
                    0.0)                                   # [e, H]
    lsum = lsum * corr + segment_sum(p, dst, N)
    acc = (acc * corr.repeat_interleave(C // H, dim=1)[..., None]
           + segment_sum(_weighted(mw.float(), p, H), dst, N))
    return mx_new, lsum, acc


def _aggregate(xn, lp, cfg, path, src, dst, m, Dk, rbf, env, so2):
    """The attention-weighted sum of messages at each node, ``[N, C,
    dim]``, on ``path`` (``_path``)."""
    N, C, dim = xn.shape
    H = cfg.n_heads
    E = src.shape[0]
    if path[0] == "default":
        mw, logits = _edge_messages(xn, lp, cfg, src, Dk, rbf, env, so2)
        alpha = segment_softmax(logits, dst, N, mask=m[:, None])
        return segment_sum(_weighted(mw, alpha, H), dst, N)
    if path[0] == "node":
        nch = path[1]
        Nc, Ec = N // nch, E // nch
        # each part lands in its rows of one result: no list of parts is
        # kept beside their concatenation
        agg = xn.new_empty(N, C, dim)
        for c in range(nch):
            e = slice(c * Ec, (c + 1) * Ec)
            agg[c * Nc:(c + 1) * Nc] = _ckpt(
                _node_chunk, xn, lp, cfg, c * Nc, Nc, src[e], dst[e], m[e],
                Dk[e], rbf[e], env[e], so2)
        return agg
    chunk = path[1]
    mx = torch.full((N, H), -1e30, dtype=torch.float32, device=xn.device)
    lsum = torch.zeros((N, H), dtype=torch.float32, device=xn.device)
    acc = torch.zeros((N, C, dim), dtype=torch.float32, device=xn.device)
    for s in range(0, E, chunk):
        e = slice(s, s + chunk)
        mx, lsum, acc = _ckpt(_edge_chunk, mx, lsum, acc, xn, lp, cfg,
                              src[e], dst[e], m[e], Dk[e], rbf[e], env[e],
                              so2)
    denom = torch.clamp(lsum, min=1e-30).repeat_interleave(C // H, dim=1)
    return (acc / denom[..., None]).to(cfg.dtype)


def _layer(x, lp, cfg, slices, path, src, dst, m, Dk, rbf, env, so2):
    xn = _equi_layernorm(x, lp.ln_scale.to(cfg.dtype), slices)
    agg = _aggregate(xn, lp, cfg, path, src, dst, m, Dk, rbf, env, so2)
    agg = agg / math.sqrt(cfg.avg_neighbors)
    # node update: per-l mixing + gate
    upd = per_l_mix(agg, lp.mix.to(cfg.dtype), slices)
    x = x + gate(upd, lp.gate_w, lp.gate_b, slices)
    # scalar FFN (per-node)
    ff = F.silu(x[..., 0] @ lp.ffn1 + lp.ffn1_b) @ lp.ffn2
    return torch.cat([x[..., :1] + ff[..., None], x[..., 1:]], dim=-1)


def layer_inputs(batch: dict, cfg: EquiformerV2Config) -> tuple:
    """What every layer takes besides its input and weights: ``(cfg,
    slices, path, src, dst, mask, Dk, rbf, env, so2)``, the per-edge
    geometry built once a forward."""
    edges = batch["edges"]
    src, dst, _ = safe_edges(edges)
    rhat, d, m = edge_vectors(batch["positions"].to(cfg.dtype), edges)
    N = batch["positions"].shape[0]
    slices = irrep_slices(cfg.l_max)
    so2 = _so2_layout(cfg, rhat.device)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)
    env = (poly_cutoff(d, cfg.cutoff) * m)[:, None]
    Dk = _edge_frames(rhat, cfg, slices, so2[0])
    return (cfg, slices, _path(cfg, N, src.shape[0]), src, dst, m, Dk, rbf,
            env, so2)


def forward(model: EquiformerV2, batch: dict,
            cfg: EquiformerV2Config) -> torch.Tensor:
    N = batch["positions"].shape[0]
    args = layer_inputs(batch, cfg)
    x = embed_scalars(model, batch, cfg, N)
    for lp in model.layers:
        x = _ckpt(_layer, x, lp, *args)

    h = F.silu(x[..., 0] @ model.head1 + model.head1_b)
    h = h @ model.head2
    if cfg.task == "node_class":
        return h
    return graph_readout(h, batch, cfg.n_graphs)


def loss_fn(model: EquiformerV2, batch: dict, cfg: EquiformerV2Config):
    out = forward(model, batch, cfg)
    if cfg.task == "node_class":
        return masked_nll(out, batch)[0], {}
    return energy_loss(out, batch)


def make_train_step(cfg: EquiformerV2Config, adam_cfg):
    # the reference stacks the layers: one compression scale a stacked leaf
    return _train_step(loss_fn, cfg, adam_cfg, groups=opt.stacked_leaves)
