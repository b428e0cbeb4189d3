"""The port's LM training (``repro_torch.models.transformer.loss_fn`` /
``make_train_step``, the two kernels' ``autograd.Function``s and
``repro_torch.launch.train``) held against the reference on the same
weights (``params_from_reference``) and the same numpy inputs:

- ``cross_entropy`` with and without a mask;
- ``loss_fn`` and every gradient, by name, against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` on a dense, an
  MoE and a gemma2-like tiny config (loss rtol 1e-4; gradients rtol 1e-3 /
  atol 1e-4), also with the attention backward on its saved route (the
  forward's output and log-sum-exp, as on the card);
- three ``make_train_step`` steps against three jitted reference steps,
  with compression off and on (parameters and moments at 1e-3 / 1e-4);
- K3's backward against ``jax.vjp`` of an einsum (1e-4) and K2's against
  ``jax.vjp`` of the reference's ``_block_attention`` over the forward's
  options (2e-3), both on the CPU, where the Functions run their plain
  versions;
- ``launch.train`` on the CPU: it trains, resumes, and ``main`` parses its
  flags.
The kernels' backward on the card is in ``test_torch_kernels_gpu.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import transformer as jt
from repro.train import optimizer as ropt
from repro_torch import kernels
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.launch import train as launch
from repro_torch.models import common as pcommon
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4

BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab_size=61, block_q=8, block_kv=8)
CONFIGS = {
    "dense": dict(name="tiny"),
    "moe": dict(name="tiny-moe", moe=True, n_experts=4, top_k=2),
    "gemma2": dict(name="gemma-tiny", layer_pattern="local_global", window=5,
                   attn_softcap=5.0, final_softcap=3.0, post_norms=True,
                   zero_centered_norm=True),
}


def _pair(which):
    kw = {**BASE, **CONFIGS[which]}
    return (jt.TransformerConfig(**kw, dtype=jnp.float32),
            tfm.TransformerConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(reference cfg, its params, port cfg, port model on those weights).
    The gemma2-like config's zero-initialised norms are drawn, so every
    norm gradient is exercised."""
    jc, pc = _pair(request.param)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    if pc.zero_centered_norm:
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: (jnp.asarray(0.2 * rng.normal(size=x.shape),
                                         jnp.float32)
                             if "ln" in jax.tree_util.keystr(path)
                             or "final_norm" in jax.tree_util.keystr(path)
                             else x), params)
    model = tfm.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return jc, params, pc, model


def _tokens(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 61, shape).astype(np.int32)


def _ref_leaf(tree, name):
    """The reference's array for a port parameter name (layer ``i``'s
    slice of a stacked leaf)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np.asarray(tree[name])
    node = tree["layers"]
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node)[int(parts[1])]


def _close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------ cross entropy

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 19)).astype(np.float32) * 4
    labels = rng.integers(0, 19, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcommon.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = pcommon.cross_entropy(
        torch.tensor(logits), torch.tensor(labels),
        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_of_an_empty_mask_is_zero():
    got = pcommon.cross_entropy(torch.zeros(2, 5),
                                torch.zeros(2, dtype=torch.int64),
                                torch.zeros(2))
    assert float(got) == 0.0


# ------------------------------------------------------ loss and gradients

def test_train_flops_matches_reference():
    for preset in ("lm100m", "lm10m", "lm-moe"):
        cfg = launch.PRESETS[preset]
        ref = jt.TransformerConfig(**{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg) if f.name != "dtype"})
        assert cfg.train_flops(8, 1024) == ref.train_flops(8, 1024)


def test_loss_and_gradients_match_reference(pair):
    _check_loss_and_gradients(pair)


def test_saved_route_gradients_match_reference(pair, monkeypatch):
    """The card's policy applied on the CPU: ``FlashAttentionFn`` keeps the
    plain forward's output and log-sum-exp (under the layers' remat the
    recompute makes them again) and every backward takes the closed form of
    the kernels' saved route; the loss and every gradient still match
    ``jax.value_and_grad`` at the tolerances above."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real_bwd, saved = fa_ops.flash_attention_bwd, []

    def bwd(*args, **kw):
        saved.append(kw.get("lse") is not None)
        return real_bwd(*args, **kw)

    monkeypatch.setattr(fa_ops, "saves_lse", lambda q, k, v: (
        q.dtype == torch.float32 and fa_ops.route(q, k, v) == "rows"))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", bwd)
    _check_loss_and_gradients(pair)
    assert len(saved) == pair[2].n_layers and all(saved)


def _check_loss_and_gradients(pair):
    jc, params, pc, model = pair
    toks = _tokens(1)
    (want, parts), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        params, {"tokens": jnp.asarray(toks)}, jc)
    ps = [p.requires_grad_() for p in model.parameters()]
    try:
        got, gparts = tfm.loss_fn(model, {"tokens": torch.as_tensor(toks)},
                                  pc)
        gg = torch.autograd.grad(got, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(gparts[k].detach()),
                                   float(parts[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, gg):
        want_g = _ref_leaf(grads, name)
        got_g = np.zeros_like(want_g) if g is None else g.numpy()
        _close(got_g, want_g, what=name)
        # every parameter is reached, the MoE router and gates included
        assert np.abs(want_g).max() > 0, name


def test_remat_changes_no_value(pair):
    """Layers under torch.utils.checkpoint give the same loss and
    gradients as without it, and relaunch each layer's kernels once more."""
    _, _, pc, model = pair
    toks = torch.as_tensor(_tokens(2))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(pc, remat=remat)
        ps = [p.requires_grad_() for p in model.parameters()]
        try:
            kernels.reset_launches()
            loss, _ = tfm.loss_fn(model, {"tokens": toks}, cfg)
            out[remat] = (loss, torch.autograd.grad(loss, ps,
                                                    allow_unused=True),
                          dict(kernels.LAUNCHES))
        finally:
            for p in ps:
                p.requires_grad_(False)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        if a is not None or b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the CPU runs the plain versions: no kernel launch is counted
    assert out[True][2] == out[False][2] == {}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_three_train_steps_match_reference(which, compress):
    jc, pc = _pair(which)
    params = jt.init_params(jc, jax.random.PRNGKey(1))
    model = tfm.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                      device="cpu")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              compress_grads=compress)
    racfg, acfg = ropt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rstep = jax.jit(jt.make_train_step(jc, racfg))
    pstep = tfm.make_train_step(pc, acfg)
    rost = ropt.init(racfg, params)
    ost = opt.init(acfg, model.parameters())
    for i in range(3):
        toks = _tokens(10 + i)
        params, rost, rm = rstep(params, rost, {"tokens": jnp.asarray(toks)})
        model, ost, m = pstep(model, ost, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=GRAD_RTOL)
    assert int(ost.step) == int(rost.step) == 3
    names = [n for n, _ in model.named_parameters()]
    for name, p, mu, nu in zip(names, model.parameters(), ost.mu, ost.nu):
        _close(p.detach(), _ref_leaf(params, name), what=name)
        _close(mu, _ref_leaf(rost.mu, name), what=f"mu {name}")
        _close(nu, _ref_leaf(rost.nu, name), what=f"nu {name}")


def test_train_step_refuses_bf16_configs():
    _, pc = _pair("dense")
    with pytest.raises(ValueError, match="float32"):
        tfm.make_train_step(dataclasses.replace(pc, dtype=torch.bfloat16),
                            opt.AdamWConfig())


def test_params_to_reference_inverts_params_from_reference(pair):
    jc, params, pc, model = pair
    back = tfm.params_to_reference(model, pc)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# --------------------------------------------------- the kernels' backward

@pytest.mark.parametrize("G,M,K,N", [(4, 40, 24, 16), (3, 37, 65, 50),
                                     (2, 1, 8, 3)])
def test_grouped_matmul_backward_matches_jax(G, M, K, N):
    rng = np.random.default_rng(G * M + K)
    x, w = (rng.normal(size=s).astype(np.float32)
            for s in ((G, M, K), (G, K, N)))
    dy = rng.normal(size=(G, M, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("gmk,gkn->gmn", a, b),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = torch.autograd.grad(grouped_matmul(xt, wt), (xt, wt),
                              torch.tensor(dy))
    for g, r in zip(got, want):
        _close(g, r, rtol=1e-4, atol=1e-4)


def _attn_cfg(window, cap):
    return jt.TransformerConfig(name="t", n_layers=1, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=64, vocab_size=16,
                                block_q=16, block_kv=16,
                                window=window or 4096, attn_softcap=cap,
                                dtype=jnp.float32)


@pytest.mark.parametrize("case", ["prefill", "prefill_window_softcap",
                                  "chunk_arrays", "chunk_window",
                                  "decode_arrays", "decode_softcap"])
def test_attention_backward_matches_jax(case):
    """The Function's gradients (on the CPU: autograd through the plain
    version) against jax.vjp of the reference's _block_attention, with
    q_start / kv_len as ints and as [B] arrays, a window and a softcap;
    cache rows past kv_len hold values that must get no gradient."""
    rng = np.random.default_rng(len(case))
    B, Skv, K, G, hd = 3, 40, 2, 2, 16
    window = 6 if "window" in case else None
    cap = 5.0 if "softcap" in case else None
    if case.startswith("prefill"):
        Sq, q_start, kv_len = Skv, 0, Skv
    elif case.startswith("chunk"):
        Sq = 4
        q_start = np.array([3, 17, 30], np.int32)
        kv_len = q_start + Sq
    else:
        Sq = 1
        q_start = np.array([5, 23, 0], np.int32)
        kv_len = q_start + 1
    q = rng.normal(size=(B, Sq, K, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, K, hd)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    cfg = _attn_cfg(window, cap)
    _, vjp = jax.vjp(
        lambda a, b, c: jt._block_attention(
            a, b, c, cfg, jnp.asarray(q_start), jnp.asarray(kv_len),
            is_local=jnp.asarray(window is not None)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    as_port = (lambda a: a if isinstance(a, int) else torch.tensor(a))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(qt, kt, vt, as_port(q_start), as_port(kv_len),
                          window=window, softcap=cap)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))
    for g, r, n in zip(got, want, "qkv"):
        _close(g, r, rtol=2e-3, atol=2e-3, what=f"d{n}")
    # keys past every slot's kv_len get exactly zero
    past = int(np.max(kv_len))
    assert not got[1][:, past:].any() and not got[2][:, past:].any()


# ----------------------------------------------------------- launch.train

def test_launch_train_trains_and_resumes_on_the_cpu(tmp_path):
    kw = dict(preset="lm10m", batch=2, seq=32, ckpt_dir=str(tmp_path),
              device="cpu", log_fn=lambda *a: None, log_every=1)
    first = launch.train(steps=3, **kw)
    assert first.final_step == 3 and not first.preempted
    assert [s for s, _ in first.metrics_history] == [1, 2, 3]
    losses = [m["loss"] for _, m in first.metrics_history]
    assert all(np.isfinite(losses))
    again = launch.train(steps=5, **kw)
    assert again.final_step == 5
    assert [s for s, _ in again.metrics_history] == [4, 5]  # from step 3
    stop = launch.train(steps=9, should_preempt=lambda: True, **kw)
    assert stop.preempted and stop.final_step == 5


def test_launch_main_parses_its_flags(tmp_path, capsys):
    a = launch.parse_args(["--preset", "lm-moe", "--steps", "7", "--batch",
                           "3", "--seq", "16", "--ckpt-dir", "d", "--lr",
                           "1e-3", "--compress-grads", "--device", "cpu"])
    assert (a.preset, a.steps, a.batch, a.seq, a.ckpt_dir, a.lr,
            a.compress_grads, a.device) == ("lm-moe", 7, 3, 16, "d", 1e-3,
                                            True, "cpu")
    d = launch.parse_args([])
    assert (d.preset, d.device, d.ckpt_dir) == ("lm10m", None, None)
    result = launch.main(["--preset", "lm10m", "--steps", "2", "--batch",
                          "1", "--seq", "8", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    assert result.final_step == 2
    assert "done: step=2" in capsys.readouterr().out


def test_launch_train_without_a_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.train("lm10m", steps=1, batch=1, seq=8,
                     ckpt_dir=str(tmp_path))


def test_presets_are_the_reference_presets_in_float32():
    from repro.launch.train import PRESETS as REF
    assert sorted(launch.PRESETS) == sorted(REF)
    for name, cfg in launch.PRESETS.items():
        r, p = dataclasses.asdict(REF[name]), dataclasses.asdict(cfg)
        assert r.pop("dtype") == jnp.float32
        assert p.pop("dtype") == torch.float32
        assert r == p

