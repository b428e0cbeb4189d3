"""The port's Wide & Deep training (``repro_torch.models.recsys.loss_fn`` /
``make_train_step``, K4's backward and the bounded AdamW update) held
against the reference on the same weights (``params_from_reference``) and
the same numpy batches, fp32 throughout:

- ``loss_fn``'s loss and ``acc`` against ``repro.models.recsys.loss_fn``
  on ``SMOKE`` and on ``test_models.py``'s config (rtol 1e-4);
- three ``make_train_step`` steps against three jitted reference steps,
  with the reference's ``adam_cfg()`` and with a short warm-up: loss and
  gradient norm at every step, every parameter, ``mu`` and ``nu`` after
  the third (rtol 1e-3 / atol 1e-4, the LM training tests' tolerances);
- the plain backward of the bag lookup against ``jax.vjp`` of the
  reference's ``jnp.take`` lookup, and the autograd Functions
  (``EmbeddingBagFn``, ``MLPInput``) against autograd through the plain
  forward;
- the bounded ``update`` bit-equal to the update of whole tensors (a copy
  of the parent's whole-tensor code below), over many pieces;
- the twin of ``tests/test_models.py::test_recsys_train_and_retrieval``,
  and the weights that must not move under the reference's weight decay
  of 0.
The backward kernel on the card is in ``test_torch_kernels_gpu.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as jwd
from repro.models import recsys as jr
from repro.train import optimizer as ropt
from repro_torch import kernels
from repro_torch.configs import wide_deep as pwd
from repro_torch.kernels.embedding_bag.ops import (EmbeddingBagFn,
                                                   embedding_bag,
                                                   embedding_bag_backward)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_backward_ref,
                                                   embedding_bag_ref)
from repro_torch.models import recsys as pr
from repro_torch.train import optimizer as opt

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# the reference's recsys case in test_models.py
MODELS_CFG = dict(vocab_sizes=tuple([500] * 40), wide_vocab=2000,
                  n_items=1000, item_dim=16, mlp=(32, 16))
# a short warm-up, so three steps move the weights by more than the
# tolerance (the reference's 100-step warm-up gives lr 1e-5 at step 1)
SHORT = dict(lr=3e-3, warmup_steps=1, total_steps=100, weight_decay=0.0)


def _pair(which):
    """(reference cfg, its params, port cfg, port model on the CPU)."""
    if which == "SMOKE":
        jc, pc = jwd.SMOKE, pwd.SMOKE
    else:
        jc, pc = jr.WideDeepConfig(**MODELS_CFG), pr.WideDeepConfig(
            **MODELS_CFG)
    params = jr.init_params(jc, jax.random.PRNGKey(0))
    model = pr.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jc, params, pc, model


def _batch(cfg, seed, n=64):
    return jr.synthetic_batch(cfg, n, seed=seed)


def _ref_leaf(tree, name):
    """The reference's array for a port parameter name (``mlp.<i>.<w|b>``
    is ``tree["mlp"][i]["w"|"b"]``)."""
    node = tree
    for part in name.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return np.asarray(node)


def _close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("which", ["SMOKE", "test_models"])
def test_loss_fn_matches_reference(which):
    jc, params, pc, model = _pair(which)
    batch = _batch(jc, seed=7)
    want, wparts = jr.loss_fn(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, jc)
    got, parts = pr.loss_fn(model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, pc)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert float(parts["acc"]) == float(wparts["acc"])


def test_loss_fn_is_stable_at_large_logits():
    """The stable form: logits of +-200 give finite losses (a plain
    ``log(sigmoid)`` would give inf), as the reference's does."""
    jc, params, pc, model = _pair("SMOKE")
    batch = _batch(jc, seed=8, n=16)
    with torch.no_grad():
        model.wide_b.fill_(200.0)
    loss, _ = pr.loss_fn(model, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, pc)
    params = dict(params, wide_b=jnp.asarray(200.0))
    want, _ = jr.loss_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, jc)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)


# ------------------------------------------------------------- train steps

@pytest.mark.parametrize("acfg", ["adam_cfg", "short_warmup"])
@pytest.mark.parametrize("which", ["SMOKE", "test_models"])
def test_three_train_steps_match_reference(which, acfg):
    jc, params, pc, model = _pair(which)
    if acfg == "adam_cfg":
        racfg, pacfg = jwd.bundle(smoke=True).adam_cfg(), pwd.adam_cfg()
    else:
        racfg, pacfg = ropt.AdamWConfig(**SHORT), opt.AdamWConfig(**SHORT)
    rstep = jax.jit(jr.make_train_step(jc, racfg))
    pstep = pr.make_train_step(pc, pacfg)
    rost, ost = ropt.init(racfg, params), opt.init(pacfg, model.parameters())
    for i in range(3):
        batch = _batch(jc, seed=20 + i)
        params, rost, rm = rstep(params, rost, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        model, ost, m = pstep(model, ost, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=GRAD_RTOL)
        assert float(m["acc"]) == float(rm["acc"])
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(ost.step) == int(rost.step) == 3
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree.leaves(params))
    for name, p, mu, nu in zip(names, model.parameters(), ost.mu, ost.nu):
        _close(p.detach(), _ref_leaf(params, name), what=name)
        _close(mu, _ref_leaf(rost.mu, name), what=f"mu {name}")
        _close(nu, _ref_leaf(rost.nu, name), what=f"nu {name}")
    if acfg == "short_warmup":
        # the weights really moved, by more than the tolerance
        start = _pair(which)[3]
        moved = (model.mlp[0].w.detach() - start.mlp[0].w).abs().max()
        assert float(moved) > 10 * GRAD_ATOL


def test_make_concrete_matches_reference_train_half():
    """``make_concrete`` of a train shape: the reference's labelled batch
    and a fresh AdamW state of ``adam_cfg()`` over the model's
    parameters."""
    spec = pwd.SMOKE_SHAPES["train_batch"]
    model, ost, batch = pwd.make_concrete(pwd.SMOKE, spec, seed=3,
                                          device="cpu")
    _, rost, rbatch = jwd.bundle(smoke=True).make_concrete("train_batch",
                                                           seed=3)
    assert set(batch) == set(rbatch) == {"sparse_ids", "dense", "wide_ids",
                                         "labels"}
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(),
                                      np.asarray(rbatch[k]))
    params = list(model.parameters())
    assert int(ost.step) == int(rost.step) == 0
    assert [tuple(m.shape) for m in ost.mu] == [tuple(p.shape)
                                                for p in params]
    assert all(not bool(m.any()) and not bool(v.any())
               for m, v in zip(ost.mu, ost.nu))
    model2, batch2 = pwd.make_concrete(pwd.SMOKE, pwd.SMOKE_SHAPES[
        "serve_p99"], seed=3, device="cpu")
    assert "labels" not in batch2
    torch.testing.assert_close(model2.table, model.table, rtol=0, atol=0)


def test_training_lowers_the_loss_and_retrieval_stays_finite():
    """Twin of ``tests/test_models.py::test_recsys_train_and_retrieval``:
    15 steps on one batch of 128 lower the loss; retrieval after training
    scores every item, finitely."""
    cfg = pr.WideDeepConfig(**MODELS_CFG)
    params = jr.init_params(jr.WideDeepConfig(**MODELS_CFG),
                            jax.random.PRNGKey(0))
    model = pr.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in pr.synthetic_batch(cfg, 128).items()}
    acfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100,
                           weight_decay=0.0)
    step = pr.make_train_step(cfg, acfg)
    ost = opt.init(acfg, model.parameters())
    losses = []
    for _ in range(15):
        model, ost, m = step(model, ost, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    rb = {"sparse_ids": batch["sparse_ids"][:1], "dense": batch["dense"][:1],
          "candidate_ids": torch.arange(1000, dtype=torch.int32)}
    with torch.no_grad():
        scores = pr.retrieval_scores(model, rb, cfg)
    assert scores.shape == (1000,)
    assert bool(torch.isfinite(scores).all())


def test_untouched_weights_keep_their_bits():
    """With the reference's weight decay of 0 a zero gradient moves
    nothing: ``items`` and ``user_proj`` (which the CTR loss does not
    reach) keep their bits over three steps, and so do the table rows no
    batch names, while the rows the batches name move."""
    jc, params, pc, model = _pair("SMOKE")
    step = pwd.make_step(pc, "train")
    ost = opt.init(pwd.adam_cfg(), model.parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    touched = torch.zeros(pc.total_rows, dtype=torch.bool)
    # 8 examples of SMOKE name some of its 20,480 rows, not all
    for i in range(3):
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(jc, seed=40 + i, n=8).items()}
        gidx = pr.table_ids(batch["sparse_ids"], model.offsets)
        touched[gidx[gidx >= 0].long()] = True
        model, ost, _ = step(model, ost, batch)
        if i == 0:
            first = touched.clone()
            moved = (model.table != before["table"]).any(dim=1)
            assert torch.equal(moved, first)
    for n in ("items", "user_proj"):
        assert torch.equal(getattr(model, n), before[n]), n
    assert 0 < int(touched.sum()) < pc.total_rows
    assert torch.equal(model.table[~touched], before["table"][~touched])
    assert not torch.equal(model.mlp[0].w, before["mlp.0.w"])


# ----------------------------------------------------------- K4's backward

def _bag_case(seed, B=6, F=3, L=4, V=11, D=8, extra_cols=5):
    """ids with padding and ids repeated within and across bags; a
    gradient of ``B`` rows of ``F`` bags (``G = F``) inside a wider buffer
    (row stride ``F * D + extra_cols``, as the deep tower's)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(B, F, L)).astype(np.int32)
    ids[rng.random((B, F, L)) < 0.3] = -1
    ids[0, 0] = [2, 2, -1, 2]               # repeated within a bag
    ids[1, :, 0] = 2                        # and across bags
    table = rng.normal(size=(V, D)).astype(np.float32)
    buf = rng.normal(size=(B, F * D + extra_cols)).astype(np.float32)
    return ids, table, buf


@pytest.mark.parametrize("strided", [False, True])
def test_plain_backward_matches_jax_vjp(strided):
    """The gradient of the reference's ``jnp.take`` lookup (per field,
    offsets 0) with respect to the table, against the plain backward on
    ``[B * F, L]`` ids: with the cotangent as ``[B * F, D]`` rows, or as a
    ``G = F``-bags-a-row view of a wider buffer."""
    B, F, L, V, D = 6, 3, 4, 11, 8
    ids, table, buf = _bag_case(0, B, F, L, V, D)
    cot = buf[:, :F * D]
    offsets = jnp.zeros(F, jnp.int32)
    _, vjp = jax.vjp(lambda t: jr.embedding_bag(t, jnp.asarray(ids),
                                                offsets), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    flat = torch.as_tensor(ids.reshape(B * F, L))
    if strided:
        g = torch.as_tensor(buf)[:, :F * D]
        assert g.stride() == (F * D + 5, 1)
    else:
        g = torch.as_tensor(np.ascontiguousarray(cot).reshape(B * F, D))
    got = embedding_bag_backward_ref(flat, g, V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    _close(got, want, what="table gradient")
    # the wrapper runs the plain version on the CPU, counting nothing
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(embedding_bag_backward(flat, g, V), got,
                               rtol=0, atol=0)
    assert dict(kernels.LAUNCHES) == before


def test_plain_backward_skips_padding_and_ids_past_the_table():
    """Slots with ``id < 0`` (not only -1) or ``id >= V`` add nothing, as
    they read nothing in the forward; a row no slot names stays 0.  Held
    against a loop over the slots."""
    rng = np.random.default_rng(1)
    N, L, V, D = 20, 5, 30, 4
    ids = rng.integers(-3, V + 3, size=(N, L)).astype(np.int32)
    grad = rng.normal(size=(N, D)).astype(np.float32)
    want = np.zeros((V, D), np.float32)
    for n in range(N):
        for s in range(L):
            if 0 <= ids[n, s] < V:
                want[ids[n, s]] += grad[n]
    got = embedding_bag_backward_ref(torch.as_tensor(ids),
                                     torch.as_tensor(grad), V)
    _close(got, want, rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(V), ids)
    assert len(untouched) and (ids < 0).any() and (ids >= V).any()
    assert not bool(got[torch.as_tensor(untouched)].any())
    # an fp64 gradient is summed in fp64 (the card's oracle form)
    exact = embedding_bag_backward_ref(torch.as_tensor(ids),
                                       torch.as_tensor(grad).double(), V)
    assert exact.dtype == torch.float64
    _close(exact, want, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_checks_its_inputs():
    ids = torch.zeros(4, 3, dtype=torch.int32)
    g = torch.ones(4, 8)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag_backward(ids, g.double(), 10)
    with pytest.raises(TypeError, match="int32"):
        embedding_bag_backward(ids.long(), g, 10)
    with pytest.raises(ValueError, match="does not hold"):
        embedding_bag_backward(ids, torch.ones(3, 8), 10)
    with pytest.raises(ValueError, match="dense and apart"):
        embedding_bag_backward(ids, torch.ones(8, 4).t(), 10)
    with pytest.raises(ValueError, match="2\\^31"):
        embedding_bag_backward(ids, g, 2**31)
    assert embedding_bag_backward(ids, g, 10).shape == (10, 8)


@pytest.mark.parametrize("with_out", [False, True])
def test_embedding_bag_fn_gradient_equals_autograd_of_the_plain_version(
        with_out):
    """``embedding_bag`` on a table that requires a gradient runs through
    ``EmbeddingBagFn``; on the CPU its table gradient is autograd's
    through ``embedding_bag_ref``, also where the bags are written through
    ``out`` into a wider buffer."""
    B, F, L, V, D = 6, 3, 4, 11, 8
    ids, table, buf = _bag_case(2, B, F, L, V, D)
    flat = torch.as_tensor(ids.reshape(B * F, L))
    cot = torch.as_tensor(buf[:, :F * D].reshape(B * F, D))
    leaf = torch.tensor(table, requires_grad=True)
    if with_out:
        dst = torch.full((B, F * D + 5), float("nan"))
        got_bags = embedding_bag(flat, leaf, out=dst[:, :F * D])
        assert got_bags.data_ptr() == dst.data_ptr()
        (got,) = torch.autograd.grad(got_bags, leaf, cot.reshape(B, F * D))
    else:
        got_bags = embedding_bag(flat, leaf)
        (got,) = torch.autograd.grad(got_bags, leaf, cot)
    assert got_bags.grad_fn is not None
    assert type(got_bags.grad_fn).__name__ == "EmbeddingBagFnBackward"
    plain = torch.tensor(table, requires_grad=True)
    (want,) = torch.autograd.grad(embedding_bag_ref(flat, plain), plain, cot)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # an expanded gradient (autograd's for a sum) is made dense first
    (ones,) = torch.autograd.grad(EmbeddingBagFn.apply(leaf, flat, None)
                                  .sum(), leaf)
    (want1,) = torch.autograd.grad(embedding_bag_ref(flat, plain).sum(),
                                   plain)
    torch.testing.assert_close(ones, want1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["SMOKE", "test_models"])
def test_mlp_input_gradient_equals_autograd_of_the_concat(which):
    """The deep tower's in-place input (``MLPInput``): its value is the
    concat of the plain bags and ``dense``, and the table's gradient
    through it (from the first ``F*dim`` columns of the gradient, a view
    of row stride ``F*dim + n_dense``) is autograd's through the plain
    lookup and ``torch.cat``."""
    _, _, pc, model = _pair(which)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(pc, seed=9, n=16).items()}
    gidx = pr.table_ids(batch["sparse_ids"], model.offsets)
    table = model.table.detach().clone().requires_grad_()
    x = pr.MLPInput.apply(table, gidx, batch["dense"],
                          pr.mlp_input_width(pc))
    n_in = pc.n_sparse * pc.embed_dim + pc.n_dense
    assert x.shape == (16, n_in) and x.stride() == (pr.mlp_input_width(pc),
                                                    1)
    cot = torch.as_tensor(np.random.default_rng(9).normal(
        size=(16, n_in)).astype(np.float32))
    (got,) = torch.autograd.grad(x, table, cot)
    plain = model.table.detach().clone().requires_grad_()
    want_x = torch.cat([embedding_bag_ref(gidx, plain).reshape(16, -1),
                        batch["dense"]], dim=1)
    torch.testing.assert_close(x, want_x, rtol=0, atol=0)
    (want,) = torch.autograd.grad(want_x, plain, cot)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_forward_is_the_same_with_and_without_gradients():
    """Serving (no parameter requires a gradient) and training take the
    same forward: one bag call each, bit-equal logits."""
    jc, params, pc, model = _pair("SMOKE")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(jc, seed=11, n=16).items()}
    calls = []
    real = pr.bag_sum

    def spy(ids, table, out=None):
        calls.append(out.stride())
        return real(ids, table, out=out)

    pr.bag_sum = spy
    try:
        served = pr.forward(model, batch, pc)
        for p in model.parameters():
            p.requires_grad_()
        trained = pr.forward(model, batch, pc)
    finally:
        pr.bag_sum = real
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
    assert calls == [(pr.mlp_input_width(pc), 1)] * 2


# --------------------------------------------------------- bounded update

def _whole_update(cfg, grads, state, params):
    """The whole-tensor update as the port had it before the pieces
    (compression off): each line one multi-tensor launch over every
    tensor whole."""
    params = list(params)
    grads = [g.to(torch.float32) for g in grads]
    gnorm = opt.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    grads = torch._foreach_mul(grads, scale)
    step = state.step + 1
    lr = opt.schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - cfg.b1))
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - cfg.b2))
    mhat = torch._foreach_div(mu, b1c)
    vhat = torch._foreach_div(nu, b2c)
    delta = torch._foreach_div(
        mhat, torch._foreach_add(torch._foreach_sqrt(vhat), cfg.eps))
    torch._foreach_add_(delta, torch._foreach_mul(
        [p.to(torch.float32) for p in params], cfg.weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(
        [d.to(p.dtype) for d, p in zip(delta, params)], lr))
    return params, opt.AdamState(step, mu, nu, state.ef_error), {
        "grad_norm": gnorm, "lr": lr}


# a 0-d tensor, one shorter than a piece, one a whole number of pieces and
# one that is not, at a piece of 16 elements
UPDATE_SHAPES = [(), (5,), (4, 8), (7, 13), (3,), (50,)]


def _update_inputs(seed):
    rng = np.random.default_rng(seed)
    params = [torch.tensor(rng.normal(size=s).astype(np.float32))
              for s in UPDATE_SHAPES]
    grads = [[torch.tensor((3 * rng.normal(size=s)).astype(np.float32))
              for s in UPDATE_SHAPES] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("piece", [1, 16, 37, None])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_bounded_update_is_bit_equal_to_the_whole_update(piece, wd):
    """Three steps of ``update`` in pieces of ``piece`` elements (``None``:
    whole tensors) against the whole-tensor update: parameters, moments,
    gradient norm and lr equal bit for bit (``torch.equal``), with clipping
    active."""
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=wd, warmup_steps=2,
                          total_steps=10)
    params, grads = _update_inputs(0)
    a = [p.clone() for p in params]
    b = [p.clone() for p in params]
    sa, sb = opt.init(cfg, a), opt.init(cfg, b)
    for g in grads:
        _, sa, ma = opt.update(cfg, [x.clone() for x in g], sa, a,
                               piece=piece)
        _, sb, mb = _whole_update(cfg, [x.clone() for x in g], sb, b)
        assert float(ma["grad_norm"]) > cfg.clip_norm
        for k in ("grad_norm", "lr"):
            assert torch.equal(ma[k], mb[k]), k
    for what, xs, ys in (("params", a, b), ("mu", sa.mu, sb.mu),
                         ("nu", sa.nu, sb.nu)):
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and torch.equal(x, y), what
    assert torch.equal(sa.step, sb.step)


def test_bounded_update_with_compression_is_bit_equal_to_whole_pieces():
    """With the int8 compression on (each leaf whole), updates in pieces
    of 16 and of whole tensors give the same bits, residuals included."""
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                          total_steps=10, compress_grads=True)
    params, grads = _update_inputs(1)
    a = [p.clone() for p in params]
    b = [p.clone() for p in params]
    sa, sb = opt.init(cfg, a), opt.init(cfg, b)
    for g in grads:
        _, sa, _ = opt.update(cfg, [x.clone() for x in g], sa, a, piece=16)
        _, sb, _ = opt.update(cfg, [x.clone() for x in g], sb, b,
                              piece=None)
    for xs, ys in ((a, b), (sa.mu, sb.mu), (sa.nu, sb.nu),
                   (sa.ef_error, sb.ef_error)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.parametrize("piece", [1, 7, 16, 1000])
def test_update_pieces_cover_every_element_once(piece):
    """``_batches``: every element of every tensor in exactly one slice,
    slices in order, each batch ``piece`` elements but the last."""
    sizes = [1, 5, 32, 91, 0, 3, 50]
    batches = opt._batches(sizes, piece)
    seen = [np.zeros(n, int) for n in sizes]
    for batch in batches:
        for i, a, b in batch:
            assert 0 <= a < b <= sizes[i]
            seen[i][a:b] += 1
    assert all((s == 1).all() for s in seen)
    totals = [sum(b - a for _, a, b in batch) for batch in batches]
    assert all(t == piece for t in totals[:-1]) and 0 < totals[-1] <= piece
    assert opt._batches(sizes, None) == [[(i, 0, n)
                                          for i, n in enumerate(sizes)]]


def test_update_default_piece_is_256_mb():
    assert opt.PIECE * 4 == 256 * 2**20


def test_bounded_update_writes_in_place():
    """``update`` keeps its in-place contract: the same tensors come back,
    written, and the state's moment lists are the ones passed in."""
    cfg = opt.AdamWConfig()
    params, grads = _update_inputs(2)
    state = opt.init(cfg, params)
    ptrs = [p.data_ptr() for p in params]
    out, new, _ = opt.update(cfg, grads[0], state, params, piece=16)
    assert [p.data_ptr() for p in out] == ptrs
    assert new.mu is state.mu and new.nu is state.nu
    assert all(p.data_ptr() == q.data_ptr() for p, q in zip(new.mu,
                                                            state.mu))
