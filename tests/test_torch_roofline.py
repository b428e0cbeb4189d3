"""The port's roofline counter (``repro_torch.launch.roofline``) and the
kernel wrappers' meta branches it reads:

- the torch form of ``tests/test_system.py::test_roofline_scan_aware_flops``:
  the counted FLOPs of an L-layer step are L times one layer plus the
  head (the embedding is a gather), for a prefill and for a training step
  (whose layers are recomputed under ``torch.utils.checkpoint``, up to the
  last activation the backward saved), and one layer's count is the
  analytic one: its matmuls, K2's 4 hd flops an admissible pair forward
  and 10 backward;
- each of the six wrappers on the meta device: outputs of the plain
  version's shapes and dtypes, no launch counted, and the FLOPs and bytes
  it reports equal to the analytic count;
- the counter's bytes (operands and outputs of every non-view op), the
  per-dtype peaks, ZeRO-1's collectives and ``summarize``'s fields (the
  reference's, plus the peak and the kernels).
"""
import dataclasses

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch import kernels
from repro_torch.configs import get_bundle
from repro_torch.configs.base import reference_specs
from repro_torch.configs.base import tree_leaves as roofline_leaves
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_backward_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (_mask,
                                                     admissible_pairs,
                                                     flash_attention_ref)
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.kernels.wcoj_intersect import ops as wcoj_ops
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt

META = torch.device("meta")


def _tiny(n_layers: int) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(name="tiny", n_layers=n_layers, d_model=32,
                                 n_heads=4, n_kv_heads=2, d_ff=64,
                                 vocab_size=61, dtype=torch.float32)


def _count(fn, *args):
    counter = roofline.Counter()
    with counter:
        fn(*args)
    return counter


def _layer_flops(cfg, B, S, train: bool) -> float:
    D, H, K, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    mm = 2 * B * S * (D * hd * (2 * H + 2 * K) + 3 * D * F)
    pairs = B * S * (S + 1) // 2 * H
    if not train:
        return mm + 4 * hd * pairs
    # the forward, the backward's two products a matmul, and the
    # recompute under checkpoint, which stops once the last saved
    # activation is made again: every product but w2's; K2 forward twice,
    # its backward once
    return 3 * mm + (mm - 2 * B * S * F * D) + (2 * 4 + 10) * hd * pairs


@pytest.mark.parametrize("train", [False, True])
def test_counted_flops_are_layers_plus_head(train):
    B, S = 2, 24
    counts = {}
    for L in (1, 2, 3):
        cfg = _tiny(L)
        model = tfm.Transformer(cfg, META)
        tokens = torch.empty((B, S), dtype=torch.int32, device=META)
        if train:
            step = tfm.make_train_step(cfg, opt.AdamWConfig())
            ost = opt.init(opt.AdamWConfig(), model.parameters())
            c = _count(step, model, ost, {"tokens": tokens})
        else:
            caches = tfm.init_kv_cache(cfg, B, S, device=META)
            c = _count(tfm.prefill, model, tokens, cfg, caches)
        counts[L] = c.total_flops()
        assert c.kernels["flash_attention"]["calls"] == L * (2 if train
                                                             else 1)
    cfg = _tiny(1)
    layer = _layer_flops(cfg, B, S, train)
    head = (6 if train else 2) * B * S * cfg.d_model * cfg.vocab_size
    for L in (1, 2, 3):
        assert counts[L] == L * layer + head, (L, counts)


def test_counter_bytes_views_and_peaks():
    a = torch.empty((64, 32), device=META)
    b = torch.empty((64, 32), device=META)
    c = _count(lambda: (a + b, a.t(), a.reshape(32, 64)))
    assert c.bytes == 3 * 64 * 32 * 4
    assert c.total_flops() == 0
    w = torch.empty((32, 16), device=META, dtype=torch.bfloat16)
    c = _count(lambda: a.bfloat16() @ w)
    assert c.flops[torch.bfloat16] == 2 * 64 * 32 * 16
    assert c.compute_seconds() == pytest.approx(
        2 * 64 * 32 * 16 / roofline.PEAK_FLOPS_BF16)
    assert roofline.peak_flops(torch.float32) == 67e12
    assert roofline.HBM_BW == 3.35e12 and roofline.NVLINK_BW == 450e9


def test_terms_keep_the_reference_fields():
    ref = {f.name for f in dataclasses.fields(ref_roofline.RooflineTerms)}
    mine = {f.name for f in dataclasses.fields(roofline.RooflineTerms)}
    assert ref <= mine
    t = roofline.RooflineTerms(flops=1e12, bytes=1e9, peak_flops=67e12)
    want = ref_roofline.summarize(ref_roofline.RooflineTerms(
        flops=1e12, bytes=1e9), 5e11)
    got = roofline.summarize(t, 5e11)
    assert set(want) <= set(got)
    assert got["dominant"] == "compute"
    assert got["roofline_fraction"] == pytest.approx(0.5)


def test_zero1_collectives_of_a_train_cell():
    """An LM's moments are split over the data axis (ZeRO-1): a gradient
    reduce-scatter and a parameter all-gather a split leaf, at its
    per-device bytes; Wide & Deep's are not (the reference shards them as
    the parameters): an all-reduce a leaf.  No data parallelism, no
    collective."""
    from repro_torch.configs.lm_common import LMBundle
    from repro_torch.launch.train import PRESETS
    mesh = make_production_mesh()
    bundle = LMBundle(PRESETS["lm100m"])
    params = reference_specs((bundle.init_params_abstract(),))[0]
    in_sh = bundle.shardings(mesh, "train_4k")[0]
    terms = roofline.zero1_collectives(roofline.RooflineTerms(), params,
                                       in_sh[0], in_sh[1].mu, 16)
    # lm100m's 12 layers do not divide 16: ZeRO-1 splits the next axis
    assert in_sh[1].mu["layers"]["attn"]["wq"].spec == (None, "data",
                                                        "model")
    want = {"reduce-scatter": 0, "all-gather": 0, "all-reduce": 0}
    for leaf, ps, ms in zip(roofline_leaves(params),
                            roofline_leaves(in_sh[0]),
                            roofline_leaves(in_sh[1].mu)):
        shard = ps.shard_shape(leaf.shape)
        nbytes = torch.Size(shard).numel() * 4
        if "data" in ms.spec:
            want["reduce-scatter"] += nbytes
            want["all-gather"] += nbytes
        else:
            want["all-reduce"] += nbytes
    assert want["reduce-scatter"] > 0
    assert terms.collective_breakdown == {k: v for k, v in want.items()
                                          if v}
    assert terms.collective_bytes == sum(want.values())
    wd = get_bundle("wide-deep")
    wd_params = reference_specs((wd.init_params_abstract(),))[0]
    wd_sh = wd.shardings(mesh, "train_batch")[0]
    terms = roofline.zero1_collectives(roofline.RooflineTerms(), wd_params,
                                       wd_sh[0], wd_sh[1].mu, 16)
    assert set(terms.collective_breakdown) == {"all-reduce"}
    table = wd_params["table"]
    assert terms.collective_bytes >= table.nbytes // 16
    none = roofline.zero1_collectives(roofline.RooflineTerms(), params,
                                      in_sh[0], in_sh[1].mu, 1)
    assert none.collective_bytes == 0


# ------------------------------------------------------------ meta branches


class _Reports:
    def __init__(self):
        self.items = []

    def __call__(self, name, flops, nbytes, dtype):
        self.items.append((name, flops, nbytes, dtype))


def _on_meta(fn, *tensors, **kw):
    """``fn`` on meta copies of ``tensors`` (ints pass through); returns
    (outputs, the reports) and checks no launch was counted."""
    before = dict(kernels.LAUNCHES)
    reports = _Reports()
    meta = [t.to(META) if isinstance(t, torch.Tensor) else t
            for t in tensors]
    with kernels.meta_sink(reports):
        out = fn(*meta, **kw)
    assert kernels.LAUNCHES == before
    return out, reports.items


def _same_layout(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("case", [
    dict(B=2, Sq=24, Skv=24, q_start=0, kv_len=24),
    dict(B=1, Sq=1, Skv=40, q_start=30, kv_len=31),
    dict(B=2, Sq=8, Skv=40, q_start=16, kv_len=24, window=5),
    dict(B=1, Sq=33, Skv=33, q_start=0, kv_len=33, window=7, softcap=30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_meta_branch(case, dtype):
    case = dict(case)
    B, Sq, Skv = case.pop("B"), case.pop("Sq"), case.pop("Skv")
    q_start, kv_len = case.pop("q_start"), case.pop("kv_len")
    Kh, G, hd = 2, 2, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, Sq, Kh, G, hd), generator=g).to(dtype)
    k = torch.randn((B, Skv, Kh, hd), generator=g).to(dtype)
    v = torch.randn((B, Skv, Kh, hd), generator=g).to(dtype)
    pairs = int(_mask(q_start, kv_len, B, Sq, Skv, case.get("window"),
                      "cpu").sum()) * Kh * G
    assert admissible_pairs(B, Sq, Skv, q_start, kv_len,
                            case.get("window")) * Kh * G == pairs
    want = flash_attention_ref(q, k, v, q_start, kv_len, **case)
    out, rep = _on_meta(fa_ops.flash_attention, q, k, v, q_start, kv_len,
                        **case)
    _same_layout(out, want)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, want))
    assert rep == [("flash_attention", 4 * hd * pairs, nbytes, dtype)]
    dout = torch.randn_like(want)
    grads, rep = _on_meta(fa_ops.flash_attention_bwd, q, k, v, dout,
                          q_start, kv_len, **case)
    _same_layout(grads, (q, k, v))
    assert rep[0][:2] == ("flash_attention_bwd", 10 * hd * pairs)
    # under autograd: the forward and the backward both report
    reports = _Reports()
    leaves = [t.to(META).requires_grad_() for t in (q, k, v)]
    with kernels.meta_sink(reports):
        o = fa_ops.flash_attention(*leaves, q_start, kv_len, **case)
        torch.autograd.grad(o, leaves, torch.empty_like(o))
    assert [r[0] for r in reports.items] == ["flash_attention",
                                             "flash_attention_bwd"]


@pytest.mark.parametrize("tx,tw", [(False, False), (True, False),
                                   (False, True)])
def test_grouped_matmul_meta_branch(tx, tw):
    G, M, K, N = 3, 20, 12, 8
    g = torch.Generator().manual_seed(1)
    x = torch.randn((G, K, M) if tx else (G, M, K), generator=g)
    w = torch.randn((G, N, K) if tw else (G, K, N), generator=g)
    want = grouped_matmul_ref(x, w, trans_x=tx, trans_w=tw)
    out, rep = _on_meta(gmm_ops.grouped_matmul, x, w, trans_x=tx,
                        trans_w=tw)
    _same_layout(out, want)
    nbytes = 4 * (x.numel() + w.numel() + want.numel())
    assert rep == [("grouped_matmul", 2 * G * M * K * N, nbytes,
                    torch.float32)]


@pytest.mark.parametrize("with_out", [False, True])
def test_embedding_bag_meta_branches(with_out):
    N, L, V, D = 12, 5, 40, 8
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(-1, V, (N, L), generator=g, dtype=torch.int32)
    table = torch.randn((V, D), generator=g)
    out = torch.empty((N // 2, 2 * D + 4))[:, :2 * D] if with_out else None
    want = embedding_bag_ref(ids, table,
                             out=None if out is None else out.clone())
    got, rep = _on_meta(bag_ops.embedding_bag, ids, table, out)
    _same_layout(got, want)
    assert rep == [("embedding_bag", N * L * D,
                    ids.numel() * 4 + (N * L + N) * D * 4, torch.float32)]
    grad = torch.randn((N, D), generator=g)
    want = embedding_bag_backward_ref(ids, grad, V)
    got, rep = _on_meta(bag_ops.embedding_bag_backward, ids, grad, V)
    _same_layout(got, want)
    assert rep == [("embedding_bag_bwd", N * L * D,
                    ids.numel() * 4 + V * D * 4 + N * D * 4,
                    torch.float32)]


def test_wcoj_intersect_meta_branch():
    indptr = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    indices = torch.tensor([1, 4, 9, 0, 2, 5, 8], dtype=torch.int32)
    rows = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    targets = torch.tensor([4, 3, 0, 8], dtype=torch.int32)
    want = wcoj_intersect_ref(indptr, indices, rows, targets)
    got, rep = _on_meta(wcoj_ops.wcoj_intersect, indptr, indices, rows,
                        targets)
    _same_layout(got, want)
    n = rows.numel()
    assert rep == [("wcoj_intersect", 0, 4 * n + 4 * n + n + 4 * n + 8 * n,
                    torch.int32)]
