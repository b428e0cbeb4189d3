"""The train step every model family's ``make_train_step`` returns (the LM
in ``models/transformer.py``, each GNN in ``models/gnn/``): the loss's
gradients by autograd, then one step of the reference's AdamW
(``optimizer.py``) on the parameters in place."""
from __future__ import annotations

import torch

from repro_torch.train import optimizer as opt


def make_train_step(loss_fn, cfg, adam_cfg, groups=None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: ``loss_fn(model, batch, cfg) -> (loss, parts)``
    differentiated for every parameter (turning ``requires_grad`` on; zeros
    for one the loss does not reach, as JAX's gradient), then one AdamW
    update.  ``groups(model)``, where given, names the parameters that are
    one leaf of the reference's tree (``opt.update``'s ``groups``: one int8
    scale a leaf under compression)."""

    def train_step(model, opt_state, batch):
        params = [p.requires_grad_() for p in model.parameters()]
        loss, parts = loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        _, opt_state, om = opt.update(
            adam_cfg, grads, opt_state, params,
            groups=None if groups is None else groups(model))
        return model, opt_state, {"loss": loss.detach(),
                                  **{k: v.detach() for k, v in parts.items()},
                                  **om}

    return train_step
