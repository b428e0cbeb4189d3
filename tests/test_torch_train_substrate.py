"""The port's training substrate (``repro_torch.train.{data,checkpoint,
loop}``) held against the reference's: the twins of
``tests/test_train_substrate.py``'s checkpoint, loop and data tests on the
port's tiny LM, and checkpoints that cross-load both ways (a checkpoint
written by either package restores in the other, and training then goes
on alike: equal losses, parameters within 1e-5)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.models import transformer as jt
from repro.train import optimizer as ropt
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.data import batch_at as ref_batch_at
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager, flatten, state_tree
from repro_torch.train.data import DataConfig, TokenPipeline, batch_at
from repro_torch.train.loop import LoopConfig, run_loop

CROSS_ATOL = 1e-5


def _cfgs():
    kw = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=61, block_q=8, block_kv=8)
    return (jt.TransformerConfig(**kw, dtype=jnp.float32),
            tfm.TransformerConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module")
def tiny():
    """(reference cfg, its params, port cfg, port model on the same
    weights)."""
    jc, pc = _cfgs()
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    model = tfm.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return jc, params, pc, model


def _fresh(pc, seed=1):
    return tfm.init_params(pc, torch.Generator().manual_seed(seed),
                           device="cpu")


def _batch_fn(step):
    r = np.random.default_rng(step)
    return {"tokens": torch.as_tensor(r.integers(0, 61, (2, 12))
                                      .astype(np.int32))}


def _assert_model_equal(a, b):
    for (n, p), (m, q) in zip(a.named_parameters(), b.named_parameters()):
        assert n == m
        torch.testing.assert_close(p, q, rtol=0, atol=0)


# ------------------------------------------------------------- checkpointing

def test_checkpoint_roundtrip(tmp_path, tiny):
    _, _, pc, model = tiny
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    ck.save(5, model)
    other = _fresh(pc)
    step, restored = ck.restore_latest(other)
    assert step == 5 and restored is other
    _assert_model_equal(other, model)


def test_checkpoint_retention_and_corrupt_skip(tmp_path, tiny):
    _, _, pc, model = tiny
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3):
        ck.save(s, model)
    assert ck.steps() == [2, 3]
    # corrupt the newest: restore must fall back to the previous one
    os.truncate(os.path.join(str(tmp_path), "step_000000003", "arrays.npz"),
                8)
    other = _fresh(pc)
    step, restored = ck.restore_latest(other)
    assert step == 2 and restored is other
    _assert_model_equal(other, model)


def test_async_checkpoint(tmp_path, tiny):
    _, _, pc, model = tiny
    ck = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    work = _fresh(pc)
    want = work.embed.detach().clone()
    ck.save(1, work)
    # the snapshot is taken at save: a later in-place write does not reach it
    with torch.no_grad():
        work.embed.add_(1.0)
    ck.wait()
    assert ck.steps() == [1]
    other = _fresh(pc, seed=2)
    ck.restore(1, other)
    torch.testing.assert_close(other.embed, want, rtol=0, atol=0)


def test_restore_refuses_a_checkpoint_of_another_shape(tmp_path, tiny):
    """Every leaf is checked before any is written: a checkpoint of another
    model leaves the state as it was."""
    _, _, pc, model = tiny
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    ck.save(1, model)
    import dataclasses
    wider = dataclasses.replace(pc, d_ff=96)
    other = _fresh(wider)
    before = [p.clone() for p in other.parameters()]
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, other)
    assert ck.restore_latest(other) == (None, None)
    for p, q in zip(other.parameters(), before):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_state_flattens_in_the_reference_leaf_order(tiny):
    """(model, AdamState) flattens to the reference's (params, AdamState)
    leaves, shape for shape, and the model to its params."""
    jc, params, pc, model = tiny
    for compress in (False, True):
        acfg = opt.AdamWConfig(compress_grads=compress)
        rstate = (params, ropt.init(ropt.AdamWConfig(compress_grads=compress),
                                    params))
        ours = flatten(state_tree((model, opt.init(acfg,
                                                   model.parameters()))))
        ref = jax.tree.leaves(rstate)
        assert len(ours) == len(ref)
        for mine, theirs in zip(ours, ref):
            shape = ((len(mine),) + tuple(mine[0].shape)
                     if isinstance(mine, list) else tuple(mine.shape))
            if isinstance(mine, list) and not mine[0].shape:
                shape = ()    # one residual scalar per stacked leaf
            assert shape == np.shape(theirs)
    flat = flatten(state_tree(model))
    for mine, theirs in zip(flat, jax.tree.leaves(params)):
        got = (np.stack([t.detach().numpy() for t in mine])
               if isinstance(mine, list) else mine.detach().numpy())
        np.testing.assert_array_equal(got, np.asarray(theirs))


# -------------------------------------------------------------- loop / FT

def test_loop_retry_resume_preempt(tmp_path, tiny):
    _, _, pc, _ = tiny
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)
    model = _fresh(pc, seed=0)
    ost = opt.init(acfg, model.parameters())
    raw = tfm.make_train_step(pc, acfg)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected transient failure")
        p, o = state
        p, o, m = raw(p, o, batch)
        return (p, o), m

    ck = CheckpointManager(str(tmp_path), keep=2)
    res = run_loop(step_fn, (model, ost), _batch_fn, ck,
                   LoopConfig(total_steps=20, ckpt_every=5, log_every=5),
                   log_fn=lambda *a: None)
    assert res.final_step == 20 and res.retries == 1
    res2 = run_loop(step_fn, (model, ost), _batch_fn, ck,
                    LoopConfig(total_steps=30, ckpt_every=5, log_every=5),
                    log_fn=lambda *a: None)
    assert res2.final_step == 30    # resumed from 20, not from 0
    res3 = run_loop(step_fn, (model, ost), _batch_fn, ck,
                    LoopConfig(total_steps=99, ckpt_every=5, log_every=5),
                    should_preempt=lambda: True, log_fn=lambda *a: None)
    assert res3.preempted and res3.final_step == 30


def test_loop_rematerialises_from_the_checkpoint(tmp_path, tiny):
    """A step that fails more than max_retries times restores the last
    checkpoint in place and resumes at its step."""
    _, _, pc, _ = tiny
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=60)
    model = _fresh(pc, seed=0)
    ost = opt.init(acfg, model.parameters())
    raw = tfm.make_train_step(pc, acfg)
    seen, fails = [], {"left": 4}

    def step_fn(state, batch):
        step = int(state[1].step)
        if step == 7 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("flaky host")
        seen.append(step)
        p, o = state
        p, o, m = raw(p, o, batch)
        return (p, o), m

    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    res = run_loop(step_fn, (model, ost), _batch_fn, ck,
                   LoopConfig(total_steps=10, ckpt_every=5, max_retries=3,
                              log_every=5), log_fn=lambda *a: None)
    assert res.final_step == 10 and res.retries == 4
    assert seen == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]


# ----------------------------------------------------------------- pipeline

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 8))
def test_data_deterministic_and_host_sharded(step, n_hosts):
    _check_data(step, n_hosts)


@pytest.mark.parametrize("step,n_hosts", [(0, 1), (1, 2), (77, 3),
                                          (4096, 8), (10_000, 5)])
def test_data_deterministic_and_host_sharded_cases(step, n_hosts):
    _check_data(step, n_hosts)


def _check_data(step, n_hosts):
    cfg = DataConfig(vocab_size=101, seq_len=16, global_batch=8 * n_hosts,
                     n_hosts=n_hosts, host_id=0)
    a = batch_at(cfg, step)
    b = batch_at(cfg, step)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # the port's copy draws the reference's batches
    np.testing.assert_array_equal(a["tokens"],
                                  ref_batch_at(cfg, step)["tokens"])
    assert a["tokens"].shape == (8, 16)
    assert a["tokens"].max() < 101
    if n_hosts > 1:
        other = batch_at(DataConfig(vocab_size=101, seq_len=16,
                                    global_batch=8 * n_hosts,
                                    n_hosts=n_hosts, host_id=1), step)
        assert not np.array_equal(a["tokens"], other["tokens"])


def test_token_pipeline_resumes_at_its_step():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    pipe = TokenPipeline(cfg, start_step=3)
    for step in (3, 4):
        np.testing.assert_array_equal(next(pipe)["tokens"],
                                      batch_at(cfg, step)["tokens"])


def test_data_has_learnable_structure(tiny):
    """The port's tiny LM beats its first losses on this pipeline by 0.2
    in 60 steps, as the reference's does."""
    _, _, pc, _ = tiny
    model = _fresh(pc, seed=0)
    dcfg = DataConfig(vocab_size=pc.vocab_size, seq_len=32, global_batch=8)
    acfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=400,
                           weight_decay=0.0)
    step = tfm.make_train_step(pc, acfg)
    ost = opt.init(acfg, model.parameters())
    losses = []
    for i in range(60):
        b = {k: torch.as_tensor(v) for k, v in batch_at(dcfg, i).items()}
        model, ost, m = step(model, ost, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2


# --------------------------------------------------------------- cross-load

ACFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _ref_steps(jc, params, n, start=0):
    acfg = ropt.AdamWConfig(**ACFG)
    step = jax.jit(jt.make_train_step(jc, acfg))
    ost = ropt.init(acfg, params)
    losses = []
    for i in range(start, start + n):
        params, ost, m = step(params, ost, {
            "tokens": jnp.asarray(_batch_fn(i)["tokens"].numpy())})
        losses.append(float(m["loss"]))
    return params, ost, step, losses


def _assert_params_close(model, pc, ref_params, atol):
    got = tfm.params_to_reference(model, pc)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def test_reference_checkpoint_restores_in_the_port(tmp_path, tiny):
    """The reference saves (params, opt_state) after 3 jitted steps; the
    port restores it into its model and AdamState; one more step in each
    gives equal losses and parameters within 1e-5."""
    jc, params, pc, _ = tiny
    params, rost, rstep, _ = _ref_steps(jc, params, 3)
    rck = RefCheckpointManager(str(tmp_path), keep=2, async_write=False)
    rck.save(3, (params, rost))

    acfg = opt.AdamWConfig(**ACFG)
    model = _fresh(pc)
    ost = opt.init(acfg, model.parameters())
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    step, _ = ck.restore_latest((model, ost))
    assert step == 3 and int(ost.step) == 3
    _assert_params_close(model, pc, params, 0.0)

    batch = _batch_fn(3)
    params, rost, rm = rstep(params, rost,
                             {"tokens": jnp.asarray(batch["tokens"].numpy())})
    model, ost, m = tfm.make_train_step(pc, acfg)(model, ost, batch)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=CROSS_ATOL)
    _assert_params_close(model, pc, params, CROSS_ATOL)


def test_port_checkpoint_restores_in_the_reference(tmp_path, tiny):
    """The port saves (model, AdamState) after 3 steps; the reference
    restores it; one more step in each gives equal losses and parameters
    within 1e-5."""
    jc, params0, pc, model0 = tiny
    acfg = opt.AdamWConfig(**ACFG)
    model = _fresh(pc)
    model.load_state_dict(model0.state_dict())
    ost = opt.init(acfg, model.parameters())
    pstep = tfm.make_train_step(pc, acfg)
    for i in range(3):
        model, ost, _ = pstep(model, ost, _batch_fn(i))
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    ck.save(3, (model, ost))
    ck.wait()

    racfg = ropt.AdamWConfig(**ACFG)
    like = (params0, ropt.init(racfg, params0))
    step, (params, rost) = RefCheckpointManager(
        str(tmp_path), keep=2, async_write=False).restore_latest(like)
    assert step == 3 and int(rost.step) == 3
    _assert_params_close(model, pc, params, 0.0)

    batch = _batch_fn(3)
    rstep = jax.jit(jt.make_train_step(jc, racfg))
    params, rost, rm = rstep(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, rost),
                             {"tokens": jnp.asarray(batch["tokens"].numpy())})
    model, ost, m = pstep(model, ost, batch)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=CROSS_ATOL)
    _assert_params_close(model, pc, params, CROSS_ATOL)
