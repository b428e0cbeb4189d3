"""AdamW, the port of ``src/repro/train/optimizer.py``: decoupled weight
decay, global-norm clipping, linear warmup then cosine decay, and the
optional int8 error-feedback gradient compression.

Same arithmetic, step for step, as the reference's pytree functions, over
a list of parameters and the list of their gradients: the gradients are
cast to fp32, optionally sent through the int8 round trip (one scale per
leaf of the reference's tree, ``groups``; the residual carried to the
next step), clipped by their global norm; ``step + 1``
feeds the schedule and the bias corrections; ``delta = mhat / (sqrt(vhat)
+ eps) + wd * p``.  Everything stays on the parameters' device (no host
read).  ``update`` writes the new parameters and moments in place, where
the reference returns new trees.  ``torch.optim.AdamW`` is not this
function: it has no clipping, no schedule and no compression.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: list
    nu: list
    ef_error: list  # error-feedback residual (scalar zeros when compression off)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    compress_grads: bool = False   # int8 error-feedback compression


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (``step``: an integer
    tensor; the result is fp32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: AdamWConfig, params) -> AdamState:
    params = list(params)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    ef = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params] if cfg.compress_grads
          else [torch.zeros((), dtype=torch.float32, device=p.device)
                for p in params])
    dev = params[0].device if params else None
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=zeros,
                     nu=[torch.zeros_like(z) for z in zeros],
                     ef_error=ef)


def _quantize_int8(g: torch.Tensor, top: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``g`` and their scale, ``top / 127`` (``top``: the
    largest magnitude of ``g`` unless given)."""
    if top is None:
        top = torch.max(torch.abs(g))
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 round trip: returns (g_hat, new_err). The int8
    tensor is what would cross a data-parallel all-reduce."""
    (g_hat,), (new_err,) = compress_decompress_group([g], [err])
    return g_hat, new_err


def compress_decompress_group(gs: list, errs: list):
    """``compress_decompress`` over tensors that are one leaf of the
    reference's tree (a model's per-layer tensors of one stacked leaf):
    one int8 scale, from the largest magnitude of all of them.  Returns
    (g_hats, new_errs)."""
    g_comp = [g + e for g, e in zip(gs, errs)]
    top = torch.stack([torch.max(torch.abs(g)) for g in g_comp]).max()
    g_hat = []
    for g in g_comp:
        q, scale = _quantize_int8(g, top)
        g_hat.append(q.to(torch.float32) * scale)
    return g_hat, [g - h for g, h in zip(g_comp, g_hat)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (each tensor's norm
    from one multi-tensor launch)."""
    norms = torch._foreach_norm([x.to(torch.float32) for x in tensors])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def stacked_leaves(model, name: str = "layers") -> list:
    """Index groups of ``model.parameters()``, each one leaf of the
    reference's tree, where the reference stacks the layers of the
    ``ModuleList`` ``name`` on a leading axis: ``<name>.<i>.<rest>``
    grouped by ``rest`` over the layers, every other parameter alone."""
    groups: dict = {}
    for i, (n, _) in enumerate(model.named_parameters()):
        head, _, tail = n.partition(".")
        key = ("stacked", tail.partition(".")[2]) if head == name else n
        groups.setdefault(key, []).append(i)
    return list(groups.values())


# elements in one piece of the update (256 MB in fp32): its temporaries
# are a few pieces, however large the parameters
PIECE = 1 << 26


def _batches(sizes: list, piece: int | None) -> list:
    """The update's pieces, as lists of ``(tensor index, start, stop)``
    slices of the flattened tensors in parameter order: each list covers
    ``piece`` elements (the last fewer), cutting a tensor where a piece
    ends; ``piece=None`` gives one list of every tensor whole."""
    if piece is None:
        return [[(i, 0, n) for i, n in enumerate(sizes)]]
    batches, batch, room = [], [], piece
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            take = min(n - start, room)
            batch.append((i, start, start + take))
            start, room = start + take, room - take
            if room == 0:
                batches.append(batch)
                batch, room = [], piece
    if batch:
        batches.append(batch)
    return batches


def _adamw(cfg: AdamWConfig, grads, mu, nu, params, scale, lr, b1c, b2c):
    """The reference's per-leaf update on lists of equal-shaped tensors
    (the gradients unscaled): ``mu``, ``nu`` and ``params`` written in
    place.  Each line is one multi-tensor (``torch._foreach_*``) launch,
    with the reference's operations in its order."""
    grads = torch._foreach_mul(grads, scale)
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - cfg.b1))
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - cfg.b2))
    del grads
    mhat = torch._foreach_div(mu, b1c)
    vhat = torch._foreach_div(nu, b2c)
    delta = torch._foreach_div(
        mhat, torch._foreach_add(torch._foreach_sqrt(vhat), cfg.eps))
    del mhat, vhat
    torch._foreach_add_(delta, torch._foreach_mul(
        [p.to(torch.float32) for p in params], cfg.weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(
        [d.to(p.dtype) for d, p in zip(delta, params)], lr))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamState, params,
           groups: list | None = None, piece: int | None = PIECE):
    """One step over ``params`` (a list of contiguous tensors, written in
    place) and ``grads`` (the same order).  Returns (params, new_state,
    metrics).  ``groups`` (lists of indices into ``params``, each tensor in
    one) names the tensors that are one leaf of the reference's tree, so
    that compression quantizes each leaf with one scale as the reference
    does; by default each tensor is its own leaf.

    The global norm and the clipping scale are taken over the whole list;
    then the moments and parameters are updated ``piece`` elements at a
    time (``_batches``: flat slices of the tensors, a large one cut into
    many), so the temporaries never hold more than four pieces in fp32
    (1 GiB at ``PIECE``; five for non-fp32 parameters) whatever the
    parameters' size: Wide & Deep's 14.78 GB of weights update beside
    their gradients and moments on an 80 GB card.  Every operation is
    elementwise, so the result is bit-equal to the update of whole tensors
    (``piece=None``).  The int8 compression (off in every Wide & Deep
    configuration) still takes each leaf whole: its scale is the leaf's
    largest magnitude, and its residual is a tensor of the leaf's size."""
    params = list(params)
    grads = [g.to(torch.float32) for g in grads]
    if cfg.compress_grads:
        grads, new_err = list(grads), list(state.ef_error)
        for group in groups or [[i] for i in range(len(params))]:
            hats, errs = compress_decompress_group(
                [grads[i] for i in group], [new_err[i] for i in group])
            for i, h, e in zip(group, hats, errs):
                grads[i], new_err[i] = h, e
    else:
        new_err = state.ef_error
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    mu, nu = state.mu, state.nu
    # flat views: params and moments must be views (written in place), a
    # gradient may be copied to flatten it
    flat = {"g": [g.reshape(-1) for g in grads],
            "m": [m.view(-1) for m in mu], "v": [v.view(-1) for v in nu],
            "p": [p.view(-1) for p in params]}
    for batch in _batches([p.numel() for p in params], piece):
        g, m, v, p = ([ts[i][a:b] for i, a, b in batch]
                      for ts in flat.values())
        _adamw(cfg, g, m, v, p, scale, lr, b1c, b2c)
    return params, AdamState(step, mu, nu, new_err), {
        "grad_norm": gnorm, "lr": lr}
