"""The port's mixed-precision LM training (fp32 master parameters, cast to
the config's bf16 at each use) held against the reference's, which keeps
fp32 masters (``src/repro/models/transformer.py::init_params``), on the same
numpy weights and tokens:

- loss and every gradient leaf of the five LM smoke bundles' ``train_4k``
  step (the reference's ``make_concrete(seed=0)``): the port's model from
  ``params_from_reference(..., master=True)``; loss rtol 2e-2 and each
  leaf's max abs difference at most 2e-2 of that leaf's largest reference
  value (bf16 keeps 8 bits: one rounding of an activation is 2^-9 of it,
  and the two packages round at other places, e.g. torch's ``silu`` in
  one fp32 pass where jax rounds ``x * sigmoid(x)`` op by op);
- the dense bundles against the reference's jitted gradient (what its
  ``make_train_step`` differentiates); the MoE bundles after asserting that
  both sides send every token to the same experts at every layer (see
  ``test_moe_bf16_step_matches_reference_op_by_op`` and
  ``test_moe_bf16_layers_match_reference_on_its_inputs`` for why and
  how);
- three AdamW steps, dense and MoE: masters, ``mu`` and ``nu``;
- a serving model keeps its bf16 weights (the same draws), a training
  model holds fp32 everywhere, and ``make_train_step`` refuses a model
  without masters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as ref_get_bundle
from repro.models import transformer as jt
from repro.train import optimizer as ropt
from repro_torch.configs import get_bundle
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt

DENSE = ("gemma2-27b", "phi3-medium-14b", "qwen2.5-32b")
MOE = ("moonshot-v1-16b-a3b", "olmoe-1b-7b")
LOSS_RTOL = 2e-2
LEAF_TOL = 2e-2     # of the leaf's largest reference value
# three AdamW steps, each in norm over a leaf: mu (linear in the gradients,
# which differ by a few 1e-3 of a leaf in norm), nu (quadratic) and a
# master's displacement (see _check_state)
MU_TOL, NU_TOL, STEP_TOL = 3e-2, 4e-2, 0.15
ADAM = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _ref_leaf(tree, name):
    """The reference's array for a port parameter name (layer ``i``'s
    slice of a stacked leaf)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np.asarray(tree[name], np.float32)
    node = tree["layers"]
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node, np.float32)[int(parts[1])]


def _smoke(arch):
    """(reference cfg, its fp32 params, port cfg, tokens) of the smoke
    bundle's ``train_4k`` cell, in the config's own dtype (bf16)."""
    ref, port = ref_get_bundle(arch, smoke=True), get_bundle(arch, smoke=True)
    params, _, batch = ref.make_concrete("train_4k", seed=0)
    assert port.cfg.dtype == torch.bfloat16
    return ref.cfg, params, port.cfg, np.array(batch["tokens"])


def _port_grads(model, toks, cfg, force=None):
    """Loss and the gradient of every parameter (by name) through
    ``loss_fn``; ``force`` as ``_forced``."""
    ps = [p.requires_grad_() for p in model.parameters()]
    try:
        with _forced(model, force):
            loss, _ = tfm.loss_fn(model, {"tokens": torch.as_tensor(toks)},
                                  cfg)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    return float(loss.detach()), {
        n: (np.zeros(p.shape, np.float32) if g is None else g.numpy())
        for (n, p), g in zip(model.named_parameters(), grads)}


class _forced:
    """Within it, layer ``i`` of ``model`` takes ``force[i]`` (the
    reference's input of that layer) as its input's value while the
    gradient still flows to the input it was given: ``x_ref + (x -
    x.detach())``.  ``None`` forces nothing."""

    def __init__(self, model, force):
        self.index = {id(m): i for i, m in enumerate(model.layers)}
        self.force = force

    def __enter__(self):
        self.real = tfm._layer
        if self.force is not None:
            def layer(x, lp, *args, **kw):
                x_ref = torch.as_tensor(
                    self.force[self.index[id(lp)]]).to(x.dtype)
                return self.real(x_ref + (x - x.detach()), lp, *args, **kw)
            tfm._layer = layer
        return self

    def __exit__(self, *exc):
        tfm._layer = self.real


def _port_routes(model, toks, cfg, force=None):
    """Each MoE layer's experts per token (sorted), from the port's
    router on that layer's input."""
    got, real = [], tfm.moe_mlp

    def moe(x, mp, c):
        xf = x.reshape(-1, x.shape[-1]).float()
        probs = torch.softmax(xf @ mp.router.float(), dim=-1)
        got.append(np.sort(torch.topk(probs, c.top_k)[1].numpy(), -1))
        return real(x, mp, c)

    tfm.moe_mlp = moe
    try:
        with torch.no_grad(), _forced(model, force):
            tfm.forward(model, torch.as_tensor(toks), cfg)
    finally:
        tfm.moe_mlp = real
    return got


def _ref_op_by_op(params, toks, cfg):
    """The reference run op by op (``jax.disable_jit()``, ``remat=False``,
    which changes no value): ``_ref_op_by_op_forward``'s layer inputs and
    experts, then the loss and every gradient."""
    out = _ref_op_by_op_forward(params, toks, cfg)
    with jax.disable_jit():
        (loss, _), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            params, {"tokens": jnp.asarray(toks)},
            dataclasses.replace(cfg, remat=False))
    return {**out, "loss": float(loss), "grads": grads}


def _ref_op_by_op_forward(params, toks, cfg):
    """The reference's forward op by op: each layer's input and each MoE
    layer's experts per token (sorted)."""
    cfg = dataclasses.replace(cfg, remat=False)
    inputs, routes = [], []
    real_layer, real_moe = jt._layer, jt.moe_mlp

    def layer(x, *args, **kw):
        inputs.append(np.asarray(x, np.float32))   # exact for bf16
        return real_layer(x, *args, **kw)

    def moe(x, lp, c):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ lp["router"].astype(jnp.float32), -1)
        routes.append(np.sort(np.asarray(jax.lax.top_k(probs, c.top_k)[1]),
                              -1))
        return real_moe(x, lp, c)

    jt._layer, jt.moe_mlp = layer, moe
    try:
        with jax.disable_jit():
            jt.forward(params, jnp.asarray(toks), cfg)
    finally:
        jt._layer, jt.moe_mlp = real_layer, real_moe
    return {"inputs": inputs, "routes": routes}


def _check_leaves(got_loss, got, want_loss, want_grads):
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for name, g in got.items():
        want = _ref_leaf(want_grads, name)
        top = float(np.abs(want).max())
        assert top > 0, name
        err = float(np.abs(g - want).max())
        assert err <= LEAF_TOL * top, (
            f"{name}: max abs difference {err} is {err / top:.4f} of the "
            f"leaf's largest reference value {top}")


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("arch", DENSE)
def test_dense_bf16_step_matches_jitted_reference(arch):
    rc, params, pc, toks = _smoke(arch)
    (want, _), grads = jax.jit(
        lambda p, b: jax.value_and_grad(jt.loss_fn, has_aux=True)(p, b, rc))(
        params, {"tokens": jnp.asarray(toks)})
    model = tfm.params_from_reference(pc, _np32(params), device="cpu",
                                      master=True)
    loss, got = _port_grads(model, toks, pc)
    _check_leaves(loss, got, float(want), grads)


@pytest.fixture(scope="module")
def moe_reference():
    """Per MoE smoke bundle: its configs, weights, tokens and the
    reference run op by op (computed once: ~30 s each on the CPU)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rc, params, pc, toks = _smoke(arch)
            cache[arch] = (rc, params, pc, toks,
                           _ref_op_by_op(params, toks, rc))
        return cache[arch]

    return get


def test_moe_bf16_step_matches_reference_op_by_op(moe_reference):
    """OLMoE's smoke bundle, the whole model: both sides pick the same
    experts for all 128 tokens at both layers (the smallest top-k margin of
    layer 0 is 1.4e-4), then the loss and every gradient at the bound.

    The reference is run op by op.  Jitted, it is the same function but
    not the same numbers: XLA's fusion rounds elsewhere in bf16 (CE 5.99150
    jitted against 5.99309 op by op on this batch), which flips a router
    near-tie, and its gradients then differ from the port's by up to 0.39
    of a leaf's largest value (``mlp/w2``; ``head`` 0.21), as far as the
    jitted reference's own bf16 gradients lie from its fp32 ones.  The
    port's lie within 0.0125 of the op-by-op reference's.

    Moonshot's smoke bundle is not compared whole: on its seed-0 batch
    three tokens of layer 1 lie within 8.7e-5 to 7.0e-4 of a top-k tie,
    and one bf16 step of difference in layer 0's output (0.0156, the
    packages' roundings) moves layer 1's router probabilities by up to
    2.3e-3, so the two sides route those tokens apart in either mode of
    the reference.  The next test holds it layer by layer instead."""
    rc, params, pc, toks, ref = moe_reference("olmoe-1b-7b")
    model = tfm.params_from_reference(pc, _np32(params), device="cpu",
                                      master=True)
    routes = _port_routes(model, toks, pc)
    assert len(routes) == len(ref["routes"]) == pc.n_layers
    for i, (a, b) in enumerate(zip(routes, ref["routes"])):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} experts")
    loss, got = _port_grads(model, toks, pc)
    _check_leaves(loss, got, ref["loss"], ref["grads"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_layers_match_reference_on_its_inputs(arch, moe_reference):
    """Each MoE smoke bundle with every layer of the port fed the
    reference's input of that layer (its value; the gradient still flows
    through the port's own layers, ``_forced``), so a near-tie upstream
    cannot send a token elsewhere: the same experts at every layer,
    asserted, then the loss and every gradient leaf against the reference
    op by op at the bound."""
    rc, params, pc, toks, ref = moe_reference(arch)
    model = tfm.params_from_reference(pc, _np32(params), device="cpu",
                                      master=True)
    routes = _port_routes(model, toks, pc, force=ref["inputs"])
    assert len(routes) == len(ref["routes"]) == pc.n_layers
    for i, (a, b) in enumerate(zip(routes, ref["routes"])):
        np.testing.assert_array_equal(a, b, err_msg=f"layer {i} experts")
    loss, got = _port_grads(model, toks, pc, force=ref["inputs"])
    _check_leaves(loss, got, ref["loss"], ref["grads"])


# ------------------------------------------------------------ three steps

def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_state(model, ost, start, params, rost):
    """After the steps: every master, ``mu`` and ``nu`` fp32; ``mu``
    within ``MU_TOL`` and ``nu`` within ``NU_TOL`` of the reference's in
    norm; each master's displacement from ``start`` within ``STEP_TOL`` of
    the reference's in norm, except a key bias: a bias added to every key
    of a head shifts each of a query's scores by one amount, which the
    softmax removes, so its gradient is 0 up to rounding on both sides and
    AdamW turns that noise into full steps of either sign; it is held to
    the update's own bound (each step moves a master by at most lr x
    |mhat| / sqrt(vhat) <= lr over three steps of these betas, plus the
    decay)."""
    lrs = [float(ropt.schedule(ropt.AdamWConfig(**ADAM), jnp.int32(t)))
           for t in range(1, int(rost.step) + 1)]
    for (name, p), mu, nu in zip(model.named_parameters(), ost.mu, ost.nu):
        assert p.dtype == mu.dtype == nu.dtype == torch.float32, name
        assert _rel(mu.numpy(), _ref_leaf(rost.mu, name)) <= MU_TOL, name
        assert _rel(nu.numpy(), _ref_leaf(rost.nu, name)) <= NU_TOL, name
        p0, want = _ref_leaf(start, name), _ref_leaf(params, name)
        got = p.detach().numpy()
        if name.endswith("attn.bk"):
            bound = 2 * sum(lr * (1 + 0.1 * float(np.abs(p0).max()) + 1e-3)
                            for lr in lrs)
            assert float(np.abs(got - want).max()) <= bound, name
        else:
            assert _rel(got - p0, want - p0) <= STEP_TOL, name


def test_three_dense_bf16_steps_match_reference():
    """Qwen's smoke bundle (QKV biases included), three AdamW steps on fp32
    masters against the reference's jitted ``make_train_step``, held as
    ``_check_state`` says.  Elementwise the masters may differ by a few
    steps of lr where a gradient is near 0 (a small difference can turn
    the sign of mhat / sqrt(vhat) there), so the displacements are held in
    norm: over a leaf they agree within 0.086 of the step (my CPU run),
    where a master kept in bf16 would not move at all (its rounding step
    of 2^-8 at 1 exceeds lr 1e-3)."""
    arch = "qwen2.5-32b"
    ref, port = ref_get_bundle(arch, smoke=True), get_bundle(arch,
                                                             smoke=True)
    rc, pc = ref.cfg, port.cfg
    params = start = jt.init_params(rc, jax.random.PRNGKey(1))
    model = tfm.params_from_reference(pc, _np32(params), device="cpu",
                                      master=True)
    racfg, acfg = ropt.AdamWConfig(**ADAM), opt.AdamWConfig(**ADAM)
    rstep = jax.jit(jt.make_train_step(rc, racfg))
    pstep = tfm.make_train_step(pc, acfg)
    rost, ost = ropt.init(racfg, params), opt.init(acfg, model.parameters())
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(
            0, rc.vocab_size, (2, 64)).astype(np.int32)
        params, rost, rm = rstep(params, rost, {"tokens": jnp.asarray(toks)})
        model, ost, m = pstep(model, ost, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=LOSS_RTOL)
    assert int(ost.step) == int(rost.step) == 3
    _check_state(model, ost, start, params, rost)


def test_three_moe_bf16_steps_match_reference():
    """A two-layer MoE (``test_torch_lm_train.py``'s, 4 experts top-2) in
    bf16, three AdamW steps against the reference's ``make_train_step`` run
    op by op.  Each step feeds every port layer the reference's input of
    that layer (``_forced``, from the reference's forward at its own
    masters) and asserts the same experts at every layer before the step,
    so a near-tie cannot flip a token (unforced, one does at step 3 and
    ``mu`` of ``layers.1.mlp.w1`` lands 0.29 of its largest value away).
    Held as the dense test."""
    kw = dict(name="tiny-moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=61, block_q=8, block_kv=8,
              moe=True, n_experts=4, top_k=2)
    rc = jt.TransformerConfig(**kw, dtype=jnp.bfloat16)
    pc = tfm.TransformerConfig(**kw, dtype=torch.bfloat16)
    params = start = jt.init_params(rc, jax.random.PRNGKey(1))
    model = tfm.params_from_reference(pc, _np32(params), device="cpu",
                                      master=True)
    racfg, acfg = ropt.AdamWConfig(**ADAM), opt.AdamWConfig(**ADAM)
    rstep = jt.make_train_step(dataclasses.replace(rc, remat=False), racfg)
    pstep = tfm.make_train_step(pc, acfg)
    rost, ost = ropt.init(racfg, params), opt.init(acfg, model.parameters())
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(0, 61, (2, 12)).astype(
            np.int32)
        ref = _ref_op_by_op_forward(params, toks, rc)
        routes = _port_routes(model, toks, pc, force=ref["inputs"])
        for j, (a, b) in enumerate(zip(routes, ref["routes"])):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"step {i} layer {j}")
        with jax.disable_jit():
            params, rost, rm = rstep(params, rost,
                                     {"tokens": jnp.asarray(toks)})
        with _forced(model, ref["inputs"]):
            model, ost, m = pstep(model, ost,
                                  {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=LOSS_RTOL)
    assert int(ost.step) == int(rost.step) == 3
    _check_state(model, ost, start, params, rost)


# ----------------------------------------------------- masters and serving

@pytest.mark.parametrize("arch", sorted(DENSE + MOE))
def test_serving_keeps_bf16_weights_and_training_holds_masters(arch):
    """A serving model (the default) keeps its matmul weights, embedding
    and head in bf16 and the router and norms in fp32, drawn as before: the
    training model's masters rounded to bf16, bit for bit.  A training
    model (``master=True``) holds every parameter in fp32, and
    ``params_to_reference`` returns them as they are."""
    cfg = get_bundle(arch, smoke=True).cfg
    gen = {m: torch.Generator().manual_seed(3) for m in (False, True)}
    serve = tfm.init_params(cfg, gen[False], device="cpu")
    train = tfm.init_params(cfg, gen[True], device="cpu", master=True)
    low = 0
    for (name, s), t in zip(serve.named_parameters(), train.parameters()):
        assert t.dtype == torch.float32, name
        fp32 = name.endswith(("router", "norm")) or ".ln" in name
        assert s.dtype == (torch.float32 if fp32 else torch.bfloat16), name
        low += s.dtype == torch.bfloat16
        assert torch.equal(s, t.to(s.dtype)), name
    assert low > 0
    ref = tfm.params_to_reference(train, cfg)
    for name, t in train.named_parameters():
        np.testing.assert_array_equal(_ref_leaf(ref, name), t.numpy())


def test_train_step_refuses_a_model_without_masters():
    cfg = get_bundle("olmoe-1b-7b", smoke=True).cfg
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    step = tfm.make_train_step(cfg, opt.AdamWConfig())
    ost = opt.init(opt.AdamWConfig(), model.parameters())
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="master"):
        step(model, ost, {"tokens": toks})
    # nothing moved, no gradient was turned on
    assert not any(p.requires_grad for p in model.parameters())
    assert int(ost.step) == 0
