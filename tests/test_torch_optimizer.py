"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``): three ``update`` steps on the
same parameters and gradients give the same parameters, moments, error
residuals, gradient norms and learning rates within 1e-6, with clipping
active, weight decay on and the int8 error-feedback compression on or off;
``schedule`` at the ends of the warm-up and of the cosine; the int8 round
trip itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref
from repro_torch.train import optimizer as opt

TOL = 1e-6
SHAPES = [(5, 3), (7,), (2, 3, 4), ()]


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "int8_error_feedback"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0],
                         ids=["clipped", "unclipped"])
def test_three_updates_match_reference(compress, clip_norm):
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm,
               warmup_steps=2, total_steps=10, compress_grads=compress)
    rcfg, pcfg = ref.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    params = _draw(0)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jst, tst = ref.init(rcfg, jp), opt.init(pcfg, tp)
    for step in range(3):
        grads = _draw(10 + step, scale=3.0)
        jp, jst, jm = ref.update(rcfg, [jnp.asarray(g) for g in grads], jst,
                                 jp)
        tp, tst, tm = opt.update(pcfg, [torch.tensor(g) for g in grads], tst,
                                 tp)
        if clip_norm == 1.0:
            assert float(jm["grad_norm"]) > clip_norm   # clipping is active
        assert int(tst.step) == int(jst.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
        for name, a, b in (("params", tp, jp), ("mu", tst.mu, jst.mu),
                           ("nu", tst.nu, jst.nu),
                           ("ef_error", tst.ef_error, jst.ef_error)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert tuple(x.shape) == y.shape, name
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=TOL, atol=TOL, err_msg=name)
    if compress:
        assert any(float(np.abs(np.asarray(e)).max()) > 0
                   for e in jst.ef_error)


def test_update_keeps_the_parameters_where_they_are():
    """The update writes into the parameters it was given (no copy)."""
    p = [torch.ones(3, 2)]
    st = opt.init(opt.AdamWConfig(warmup_steps=0), p)
    out, st, _ = opt.update(opt.AdamWConfig(warmup_steps=0),
                            [torch.full((3, 2), 0.5)], st, p)
    assert out[0] is p[0] and float(p[0].max()) < 1.0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 101, 150])
def test_schedule_matches_reference(step):
    """Warm-up (0..10), the cosine (10..100) and past its end."""
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(opt.schedule(opt.AdamWConfig(**cfg),
                             torch.tensor(step, dtype=torch.int32)))
    want = float(ref.schedule(ref.AdamWConfig(**cfg), jnp.int32(step)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if step <= 10:
        np.testing.assert_allclose(got, step / 10, rtol=TOL)
    if step >= 100:
        np.testing.assert_allclose(got, 0.1, rtol=TOL)


def test_compress_decompress_matches_reference():
    g, err = _draw(3)[0], _draw(4, scale=0.01)[0]
    want = ref.compress_decompress(jnp.asarray(g), jnp.asarray(err))
    got = opt.compress_decompress(torch.tensor(g), torch.tensor(err))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    q, scale = opt._quantize_int8(torch.tensor(g))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def test_config_defaults_match_reference():
    assert dataclasses.asdict(opt.AdamWConfig()) == dataclasses.asdict(
        ref.AdamWConfig())
    p = [torch.zeros(4, 2)]
    for compress in (False, True):
        st = opt.init(opt.AdamWConfig(compress_grads=compress), p)
        jst = ref.init(ref.AdamWConfig(compress_grads=compress),
                       [jnp.zeros((4, 2))])
        assert st.step.dtype == torch.int32
        assert [tuple(e.shape) for e in st.ef_error] == \
            [e.shape for e in jax.tree.leaves(jst.ef_error)]


def test_compression_scales_each_stacked_leaf_as_the_reference():
    """A stacked reference leaf held by the port as per-layer tensors (the
    LM's layers) is quantized with the one int8 scale of the whole leaf:
    ``groups`` names the tensors of one leaf.  Layer 1's gradients are 100x
    layer 0's, so a scale per tensor would round layer 0 differently."""
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10, compress_grads=True)
    rcfg, pcfg = ref.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    rng = np.random.default_rng(7)
    stacked = rng.normal(size=(2, 6, 5)).astype(np.float32)
    g = rng.normal(size=(2, 6, 5)).astype(np.float32) * np.array(
        [1.0, 100.0], np.float32)[:, None, None]
    jp = {"w": jnp.asarray(stacked)}
    jst = ref.init(rcfg, jp)
    jp, jst, _ = ref.update(rcfg, {"w": jnp.asarray(g)}, jst, jp)
    tp = [torch.tensor(stacked[0]), torch.tensor(stacked[1])]
    tst = opt.init(pcfg, tp)
    tp, tst, _ = opt.update(pcfg, [torch.tensor(g[0]), torch.tensor(g[1])],
                            tst, tp, groups=[[0, 1]])
    for i in range(2):
        np.testing.assert_allclose(tst.ef_error[i].numpy(),
                                   np.asarray(jst.ef_error["w"])[i],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp["w"])[i],
                                   rtol=TOL, atol=TOL)
