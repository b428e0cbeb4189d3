"""The port's Wide & Deep (``repro_torch.models.recsys`` and
``repro_torch.configs.wide_deep``) held against the reference model on the
same weights (``params_from_reference``) and the same synthetic click-log
batches: the bag lookup against the Pallas embedding bag (interpret
mode), ``forward`` and ``retrieval_scores`` on ``SMOKE`` and on the
``test_models.py`` config at rtol 1e-5 / atol 1e-6 (float32 throughout),
the configs field for field, and the batch and step helpers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as jwd
from repro.kernels.embedding_bag.ops import embedding_bag as pallas_bag
from repro.models import recsys as jr
from repro_torch import kernels
from repro_torch.configs import wide_deep as pwd
from repro_torch.models import recsys as pr
from repro_torch.models.common import count_params

RTOL, ATOL = 1e-5, 1e-6
# the reference's recsys case in test_models.py
MODELS_CFG = dict(vocab_sizes=tuple([500] * 40), wide_vocab=2000,
                  n_items=1000, item_dim=16, mlp=(32, 16))


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


@pytest.fixture(scope="module", params=["SMOKE", "test_models"])
def pair(request):
    return _pair(request.param)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("which", ["SMOKE", "CONFIG"])
def test_configs_match_reference(which):
    ref, port = getattr(jwd, which), getattr(pwd, which)
    r, p = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert r.pop("dtype") == jnp.float32 and p.pop("dtype") == torch.float32
    assert r == p
    assert port.param_count() == ref.param_count()
    assert port.total_rows == ref.total_rows
    np.testing.assert_array_equal(port.field_offsets(), ref.field_offsets())
    for shapes in ("SHAPES", "SMOKE_SHAPES"):
        rs, ps = getattr(jwd, shapes), getattr(pwd, shapes)
        assert {k: dataclasses.asdict(v) for k, v in rs.items()} == \
            {k: dataclasses.asdict(v) for k, v in ps.items()}


def test_full_config_counts():
    """The configuration the card runs: 3,695,846,976 parameters, a
    107.4M-row table whose row offsets cross 2^26 (so ``id * D`` crosses
    2^31 elements)."""
    cfg = pwd.CONFIG
    assert cfg.param_count() == 3_695_846_976
    assert cfg.total_rows * cfg.embed_dim * 4 == 13_747_200_000
    assert cfg.total_rows - 1 < 2**31 <= cfg.total_rows * cfg.embed_dim
    assert int(cfg.field_offsets()[2]) == 100_000_000


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand", "train_batch"])
def test_model_flops_match_reference(shape):
    b = jwd.bundle()
    assert pwd.model_flops(pwd.CONFIG, pwd.SHAPES[shape]) == \
        b.model_flops(shape)


def test_param_tree_and_count(pair):
    jc, params, pc, model = pair
    assert count_params(model) == pc.param_count() + 1   # + wide_b
    assert sum(np.asarray(x).size for x in jax.tree.leaves(params)) == \
        count_params(model)
    for n in ("table", "wide", "out_w", "items", "user_proj"):
        np.testing.assert_array_equal(getattr(model, n).numpy(),
                                      np.asarray(params[n]))


def test_embedding_bag_matches_model_path():
    """Twin of the reference's test: the port's model lookup (one kernel
    call for all fields) equals the reference model's take+mask lookup and
    the Pallas kernel run field by field."""
    cfg = jr.WideDeepConfig(vocab_sizes=tuple([64] * 4), n_sparse=4,
                            wide_vocab=32, n_items=16, item_dim=8,
                            mlp=(16,), max_bag=3)
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 64, size=(10, 4, 3)).astype(np.int32)
    table = rng.normal(size=(cfg.total_rows, cfg.embed_dim)).astype(
        np.float32)
    offsets = cfg.field_offsets()
    got = pr.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                           torch.as_tensor(offsets))
    model_out = jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(offsets))
    flat_ids = np.where(ids >= 0, ids + offsets[None, :, None], -1)
    kernel_out = np.concatenate([np.asarray(pallas_bag(
        jnp.asarray(flat_ids[:, f]), jnp.asarray(table), interpret=True))
        for f in range(4)], axis=-1)
    for want in (model_out, kernel_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_forward_matches_reference(pair):
    jc, params, pc, model = pair
    batch = jr.synthetic_batch(jc, 64, seed=3, with_labels=False)
    want = jr.forward(params, _jax(batch), jc)
    got = pr.forward(model, _torch(batch), pc)
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_retrieval_scores_match_reference(pair):
    jc, params, pc, model = pair
    batch = jr.synthetic_batch(jc, 1, seed=4, with_labels=False)
    batch.pop("wide_ids")
    batch["candidate_ids"] = np.random.default_rng(4).integers(
        0, jc.n_items, size=300).astype(np.int32)
    want = jr.retrieval_scores(params, _jax(batch), jc)
    got = pr.retrieval_scores(model, _torch(batch), pc)
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_synthetic_batch_is_the_reference_batch():
    for cfg_j, cfg_p in ((jwd.SMOKE, pwd.SMOKE), (jwd.CONFIG, pwd.CONFIG)):
        a = jr.synthetic_batch(cfg_j, 32, seed=11)
        b = pr.synthetic_batch(cfg_p, 32, seed=11)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_make_batch_and_step_match_reference(shape):
    """``make_batch`` builds ``make_concrete``'s batch, and ``make_step``
    runs the reference's step on it."""
    jb = jwd.bundle(smoke=True)
    params, jbatch = jb.make_concrete(shape, seed=2)
    spec = pwd.SMOKE_SHAPES[shape]
    batch = pwd.make_batch(pwd.SMOKE, spec, seed=2, device="cpu")
    assert set(batch) == set(jbatch)
    for k in batch:
        assert batch[k].device.type == "cpu"
        np.testing.assert_array_equal(batch[k].numpy(),
                                      np.asarray(jbatch[k]))
    model = pr.params_from_reference(
        pwd.SMOKE, jax.tree.map(np.asarray, params), device="cpu")
    got = pwd.make_step(pwd.SMOKE, spec.kind)(model, batch)
    want = jb.make_step(shape)(params, jbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_training_is_the_ported_step():
    """``make_step(cfg, "train")`` is ``train/step.py``'s step over the
    port's ``loss_fn``, with the reference's AdamW configuration field for
    field (lr 1e-3, no weight decay, 100,000 steps)."""
    step = pwd.make_step(pwd.SMOKE, "train")
    assert step.__module__ == "repro_torch.train.step"
    assert step.__qualname__ == "make_train_step.<locals>.train_step"
    assert dataclasses.asdict(pwd.adam_cfg()) == \
        dataclasses.asdict(jwd.bundle(smoke=True).adam_cfg())
    with pytest.raises(ValueError, match="float32"):
        pr.make_train_step(dataclasses.replace(pwd.SMOKE,
                                               dtype=torch.bfloat16),
                           pwd.adam_cfg())


def test_one_kernel_call_per_forward_and_no_launch_on_the_cpu(pair):
    """The deep tower sends every bag of the batch through one call of the
    embedding-bag wrapper; CPU tensors run its plain version, so nothing is
    counted here."""
    jc, params, pc, model = pair
    calls = []
    real = pr.bag_sum

    def spy(ids, table, out=None):
        calls.append(tuple(ids.shape))
        return real(ids, table, out=out)

    before = dict(kernels.LAUNCHES)
    pr.bag_sum = spy
    try:
        pr.forward(model, _torch(jr.synthetic_batch(jc, 8, seed=1)), pc)
    finally:
        pr.bag_sum = real
    assert calls == [(8 * pc.n_sparse, pc.max_bag)]
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("dtype,want", [(torch.float32, 1296),
                                         (torch.bfloat16, 1296)])
def test_mlp_input_width_pads_rows_to_16_bytes(dtype, want):
    """1,293 inputs (40 x 32 bag sums and 13 dense) padded to whole 16-byte
    pieces: 1,296 fp32 columns (5,184 bytes), 1,296 bf16 (2,592)."""
    cfg = dataclasses.replace(pwd.CONFIG, dtype=dtype)
    assert cfg.n_sparse * cfg.embed_dim + cfg.n_dense == 1293
    assert pr.mlp_input_width(cfg) == want
    assert want * dtype.itemsize % 16 == 0


def test_deep_tower_writes_bags_into_the_mlp_input(pair):
    """The one bag call of a forward writes into columns ``[0, F*dim)`` of
    a ``[B, mlp_input_width]`` buffer (a strided view, no concat), and the
    tower's output equals the reference's concat-then-MLP."""
    jc, params, pc, model = pair
    batch = jr.synthetic_batch(jc, 16, seed=5, with_labels=False)
    seen = []
    real = pr.bag_sum

    def spy(ids, table, out=None):
        seen.append((tuple(out.shape), out.stride()))
        return real(ids, table, out=out)

    pr.bag_sum = spy
    try:
        got = pr.deep_tower(model, _torch(batch), pc)
    finally:
        pr.bag_sum = real
    n_bags = pc.n_sparse * pc.embed_dim
    assert seen == [((16, n_bags), (pr.mlp_input_width(pc), 1))]
    want = jr.deep_tower(params, _jax(batch), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_model_embedding_bag_with_out_matches_reference():
    """``embedding_bag(table, ids, offsets, out=view)`` fills the view of a
    wider buffer with the reference model's lookup and touches nothing
    else."""
    cfg = jr.WideDeepConfig(vocab_sizes=tuple([64] * 4), n_sparse=4,
                            wide_vocab=32, n_items=16, item_dim=8,
                            mlp=(16,), max_bag=3)
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 64, size=(10, 4, 3)).astype(np.int32)
    table = rng.normal(size=(cfg.total_rows, cfg.embed_dim)).astype(
        np.float32)
    offsets = cfg.field_offsets()
    buf = torch.full((10, 4 * cfg.embed_dim + 8), -5.0)
    view = buf[:, :4 * cfg.embed_dim]
    got = pr.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                           torch.as_tensor(offsets), out=view)
    assert got.data_ptr() == buf.data_ptr()
    want = jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(offsets))
    np.testing.assert_allclose(buf[:, :4 * cfg.embed_dim].numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    assert bool((buf[:, 4 * cfg.embed_dim:] == -5.0).all())


def test_init_params_laws_and_seed():
    cfg = pwd.SMOKE
    a = pr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = pr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    assert float(a.table.abs().max()) <= 0.02 + 1e-7
    assert float(a.items.abs().max()) <= 0.1 + 1e-7
    assert not a.wide_b.any() and not a.mlp[0].b.any()
    std = float(a.mlp[0].w.std())
    fan_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    assert 0.7 < std * fan_in ** 0.5 < 1.0     # truncated at 2 sigma: ~0.88


def test_entry_points_without_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.init_params(pwd.SMOKE, g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pwd.make_batch(pwd.SMOKE, pwd.SMOKE_SHAPES["serve_p99"])
    params = jr.init_params(jwd.SMOKE, jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.params_from_reference(pwd.SMOKE,
                                 jax.tree.map(np.asarray, params))
