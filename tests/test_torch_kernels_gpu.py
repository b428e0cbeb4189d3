"""The port's CUDA kernels on the card: each against its plain version (K1's
two routes on CSRs where its walk is likely to go wrong); the LM, Wide
& Deep and the GNN smoke bundles on cuda against the CPU (Wide & Deep's
train step too, with K4's backward; EquiformerV2 on each of its
message-passing paths); fused graph chains (K1 probes inside) on cuda
against the CPU; the host-staging baseline over the cuda set; the engine's
host-sync count against ``set_sync_debug_mode`` and its spans against the
profiler's device clock.  Every test here is
marked ``gpu``
and skips itself without a card.  The file imports neither jax nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ops import route as bag_route
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import route as fa_route
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul, route
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.kernels.wcoj_intersect import ops as wcoj_ops
from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                    wcoj_intersect)
from repro_torch.kernels.wcoj_intersect.ops import route as wcoj_route
from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref
from _wcoj_cases import trouble_cases

CONFIGS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "qwen2_5_32b",
           "phi3_medium_14b", "gemma2_27b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------ K2 attention

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["prefill", "decode", "chunk", "window",
                                  "hd16", "hd64_decode"])
def test_attention_kernel_matches_plain_version(card, case, dtype):
    """On CUDA tensors the wrapper launches the kernel (counted) and agrees
    with the plain version: both the many-rows and the decode kernel."""
    g = torch.Generator(device=card).manual_seed(len(case))
    B, Skv, K, G, hd = 3, 300, 4, 2, 128
    window, cap = None, None
    if case == "hd16":
        hd = 16
    if case == "hd64_decode":
        hd, G = 64, 4
    if case in ("prefill", "window", "hd16"):
        Sq, q_start = 200, torch.tensor([0, 0, 0])
        if case == "window":
            window, cap = 37, 50.0
    elif case == "chunk":
        Sq, q_start = 16, torch.tensor([0, 100, 250])
    else:
        Sq, q_start = 1, torch.tensor([5, 150, 299])
    kv_len = q_start + Sq
    q = torch.randn(B, Sq, K, G, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    q_start, kv_len = q_start.to(card), kv_len.to(card)
    before = kernels.LAUNCHES.get("flash_attention", 0)
    got = flash_attention(q, k, v, q_start, kv_len, window=window,
                          softcap=cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, q_start, kv_len, window=window,
                               softcap=cap)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_attention_kernel_raises_instead_of_falling_back(card):
    q = torch.zeros(1, 4, 2, 1, 24, device=card)
    kv = torch.zeros(1, 4, 2, 24, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, kv, kv, 0, 4)
    q = torch.zeros(1, 4, 2, 1, 32, device=card)
    kv = torch.zeros(1, 2, 4, 32, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, kv, kv, 0, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), kv.contiguous().half(),
                        kv.contiguous().half(), 0, 4)


FA_ROUTES = ("tc", "split", "rows")


def _attention_launch(q, k, v, q_start, kv_len, want_route, **kw):
    """One wrapper call on ``want_route``: counted once in the total and
    once under that route, and under no other."""
    assert fa_route(q, k, v) == want_route
    before = {r: kernels.LAUNCHES.get(f"flash_attention.{r}", 0)
              for r in FA_ROUTES}
    total = kernels.LAUNCHES.get("flash_attention", 0)
    got = flash_attention(q, k, v, q_start, kv_len, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == total + 1
    for r in FA_ROUTES:
        assert kernels.LAUNCHES.get(f"flash_attention.{r}", 0) == (
            before[r] + (r == want_route))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "tc_ragged", "tc_chunk", "tc_window_softcap", "tc_g2_hd64", "tc_g4",
    "split_kv_len_1", "split_kv_len_skv", "split_empty_chunks",
    "split_fp32", "split_window_softcap",
    "rows_ragged", "rows_chunk", "rows_window_1", "rows_window_softcap",
    "rows_g4_hd16", "rows_hd32", "rows_hd128", "rows_bf16_hd32"])
def test_attention_route_matches_plain_version(card, case):
    """Each route of the redesigned kernel against the plain version:
    ``tc`` on a ragged Sq (not a multiple of 128), a chunk at q_start > 0,
    a window with a softcap, G = 2 at head_dim 64, G = 4 (32 query
    positions a row tile); ``split`` with kv_len 1,
    kv_len = Skv, a kv_len that leaves chunks empty, fp32, a window;
    ``rows`` (fp32 at head_dim 64 unless named) on a ragged Sq (not a
    multiple of its 64- or 128-row tiles), a chunk at q_start > 0, a
    window of 1 (each row sees only itself), a window shorter than a key
    tile with a softcap, G = 4 at head_dim 16, head_dim 32 and 128, and
    bf16 at head_dim 32 (widened on staging)."""
    g = torch.Generator(device=card).manual_seed(len(case))
    B, Skv, K, G, hd = 2, 700, 4, 1, 128
    dtype, window, cap = torch.bfloat16, None, None
    if case.startswith("rows"):
        dtype, hd, Sq, q_start = torch.float32, 64, 300, torch.tensor([0, 0])
        if case == "rows_chunk":
            Sq, q_start = 150, torch.tensor([100, 437])
        elif case == "rows_window_1":
            q_start, window = torch.tensor([0, 250]), 1
        elif case == "rows_window_softcap":
            Sq, q_start, window, cap = 333, torch.tensor([0, 250]), 20, 30.0
        elif case == "rows_g4_hd16":
            Sq, q_start, G, hd = 100, torch.tensor([0, 350]), 4, 16
        elif case == "rows_hd32":
            hd = 32
        elif case == "rows_hd128":
            q_start, hd = torch.tensor([0, 333]), 128
        elif case == "rows_bf16_hd32":
            dtype, hd, q_start = torch.bfloat16, 32, torch.tensor([0, 111])
    elif case == "tc_ragged":
        Sq, q_start = 300, torch.tensor([0, 0])
    elif case == "tc_chunk":
        Sq, q_start = 200, torch.tensor([100, 437])
    elif case == "tc_window_softcap":
        Sq, q_start, window, cap = 333, torch.tensor([0, 250]), 100, 30.0
    elif case == "tc_g2_hd64":
        Sq, q_start, G, hd = 150, torch.tensor([0, 77]), 2, 64
    elif case == "tc_g4":
        Sq, q_start, G = 100, torch.tensor([0, 350]), 4
    else:
        Sq, B = 1, 3
        q_start = {"split_kv_len_1": torch.tensor([0, 0, 0]),
                   "split_kv_len_skv": torch.tensor([Skv - 1] * 3),
                   }.get(case, torch.tensor([0, 299, Skv - 1]))
        if case == "split_fp32":
            dtype = torch.float32
        if case == "split_window_softcap":
            G, window, cap = 8, 90, 30.0
    kv_len = q_start + Sq
    want_route = case.split("_")[0]
    q = torch.randn(B, Sq, K, G, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    q_start, kv_len = q_start.to(card), kv_len.to(card)
    got = _attention_launch(q, k, v, q_start, kv_len, want_route,
                            window=window, softcap=cap)
    want = flash_attention_ref(q, k, v, q_start, kv_len, window=window,
                               softcap=cap)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tc", "split", "rows"])
def test_attention_never_reads_nan_past_kv_len(card, which):
    """OLMoE's shapes (16 kv heads, G = 1, head_dim 128, a 4096-row cache
    longer than kv_len) with every cache row at or past kv_len holding
    NaN: the output is finite and equal to the kernel's output on the same
    cache with those rows zeroed.  (The plain version is no oracle here:
    its einsum over all Skv rows turns 0 * NaN into NaN.)  The card's twin
    of ``test_keys_past_kv_len_are_never_read``; ``rows`` in fp32, with
    two slots whose kv_len ends inside a key tile."""
    g = torch.Generator(device=card).manual_seed(7)
    Skv, K, hd = 4096, 16, 128
    dtype, tol = torch.bfloat16, 2e-2
    if which == "tc":
        B, Sq = 1, 1000
        q_start = torch.tensor([0], device=card)
    elif which == "rows":
        B, Sq, dtype, tol = 2, 300, torch.float32, 2e-3
        q_start = torch.tensor([0, 1003], device=card)
    else:
        B, Sq = 8, 1
        q_start = torch.tensor([5, 127, 128, 999, 1500, 2047, 3000, 4094],
                               device=card)
    kv_len = q_start + Sq
    q = torch.randn(B, Sq, K, 1, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    past = (torch.arange(Skv, device=card)[None, :]
            >= kv_len[:, None])[:, :, None, None]
    nan_k, nan_v = k.masked_fill(past, float("nan")), v.masked_fill(
        past, float("nan"))
    zero_k, zero_v = k.masked_fill(past, 0.0), v.masked_fill(past, 0.0)
    got = _attention_launch(q, nan_k, nan_v, q_start, kv_len, which)
    want = _attention_launch(q, zero_k, zero_v, q_start, kv_len, which)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    ref = flash_attention_ref(q, zero_k, zero_v, q_start, kv_len)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# ------------------------------------------------------ K3 grouped matmul

def _gmm_operands(card, G, M, K, N, dtype):
    g = torch.Generator(device=card).manual_seed(M * N)
    x = torch.randn(G, M, K, generator=g, device=card).to(dtype)
    w = (torch.randn(G, K, N, generator=g, device=card) / K ** 0.5).to(dtype)
    return x, w


def _check_gmm(x, w, want_route):
    """One launch on ``want_route``, counted there and in the total, and
    the reference's tolerance against the plain version."""
    assert route(x, w) == want_route
    before = {k: kernels.LAUNCHES.get(k, 0) for k in (
        "grouped_matmul", "grouped_matmul.tc", "grouped_matmul.simt")}
    got = grouped_matmul(x, w)
    torch.cuda.synchronize()
    other = "simt" if want_route == "tc" else "tc"
    assert kernels.LAUNCHES["grouped_matmul"] == before["grouped_matmul"] + 1
    assert (kernels.LAUNCHES[f"grouped_matmul.{want_route}"]
            == before[f"grouped_matmul.{want_route}"] + 1)
    assert (kernels.LAUNCHES.get(f"grouped_matmul.{other}", 0)
            == before[f"grouped_matmul.{other}"])
    tol = 3e-2 if x.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), grouped_matmul_ref(x, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(64, 8, 2048, 1024), (8, 320, 256, 96),
                                     (3, 37, 65, 50), (2, 1, 1, 1)])
def test_grouped_matmul_kernel_matches_plain_version(card, G, M, K, N,
                                                      dtype):
    # fp32 and the shapes TMA cannot take run the scalar kernel
    x, w = _gmm_operands(card, G, M, K, N, dtype)
    tc = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
    _check_gmm(x, w, "tc" if tc else "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("G,M,K,N", [
    (64, 311, 2048, 1024),     # serving: prefill w1 / w3
    (64, 311, 1024, 2048),     # serving: prefill w2
    (64, 8, 2048, 1024),       # serving: decode w1 / w3
    (64, 8, 1024, 2048),       # serving: decode w2
    (5, 129, 256, 192),        # ragged M; N = 128 + 64
    (4, 1, 512, 256),          # one row
    (3, 100, 136, 200),        # N = 128 + 72, K = 2 * 64 + 8
    (2, 40, 64, 72),           # decode tiles: N = 64 + 8
])
def test_grouped_matmul_tc_route_matches_plain_version(card, G, M, K, N):
    x, w = _gmm_operands(card, G, M, K, N, torch.bfloat16)
    _check_gmm(x, w, "tc")


@pytest.mark.gpu
def test_grouped_matmul_misaligned_base_takes_simt(card):
    G, M, K, N = 4, 24, 128, 64
    x, w = _gmm_operands(card, G, M, K, N, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
    shifted = buf[1:].view(G, M, K)          # base 2 bytes past 16-aligned
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    _check_gmm(shifted, w, "simt")


@pytest.mark.gpu
def test_grouped_matmul_kernel_raises_instead_of_falling_back(card):
    x = torch.zeros(2, 4, 3, device=card).transpose(1, 2)
    w = torch.zeros(2, 4, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(x, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grouped_matmul(x.contiguous().half(), w.half())


# -------------------------------------------------------------- the model

@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_model_on_the_card_matches_the_cpu(card, name):
    """Each SMOKE config in float32 (TF32 off): prefill then per-slot
    decode on cuda (through both kernels) equals the plain versions on
    the cpu, rtol 2e-3 / atol 2e-4."""
    from repro_torch.models import transformer as tfm
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(importlib.import_module(
        f"repro_torch.configs.{name}").SMOKE, dtype=torch.float32)
    on_card = tfm.init_params(cfg, torch.Generator(card).manual_seed(0),
                              device=card)
    on_host = tfm.Transformer(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    nxt = rng.integers(0, cfg.vocab_size, (2, 1))
    out = {}
    before = dict(kernels.LAUNCHES)
    for dev, model in ((card, on_card), (torch.device("cpu"), on_host)):
        caches = tfm.init_kv_cache(cfg, 2, 24, device=dev)
        last, caches = tfm.prefill(model, torch.as_tensor(toks, device=dev),
                                   cfg, caches)
        step, _ = tfm.decode_step_multi(
            model, torch.as_tensor(nxt, device=dev), cfg, caches,
            torch.tensor([12, 12], device=dev))
        out[dev.type] = (last.cpu(), step.cpu())
    assert kernels.LAUNCHES["flash_attention"] == \
        before.get("flash_attention", 0) + 2 * cfg.n_layers
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


# --------------------------------------------------------- K4 embedding bag

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,V,D", [(100, 6, 1000, 32), (32, 1, 64, 8),
                                     (7, 12, 333, 16), (20480, 8, 5000, 32),
                                     (3, 40, 77, 80)])
def test_embedding_bag_kernel_matches_plain_version(card, B, L, V, D,
                                                    dtype):
    """Ids of every kind (padding, < -1, >= V) and D both below and above
    one warp's width; 1e-4 in fp32 (the reference's), 1e-2 in bf16 (one
    rounding of the output)."""
    g = torch.Generator(device=card).manual_seed(B + V)
    ids = torch.randint(-3, V + 5, (B, L), generator=g, device=card,
                        dtype=torch.int32)
    table = torch.randn(V, D, generator=g, device=card).to(dtype)
    before = kernels.LAUNCHES.get("embedding_bag", 0)
    got = embedding_bag(ids, table)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (B, D)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(),
                               embedding_bag_ref(ids, table).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_embedding_bag_kernel_addresses_past_2_to_the_31(card):
    """A table of more than 2^31 elements (bf16 [70M, 32], 4.5 GB) read
    near its end: a 32-bit row offset would wrap."""
    V, D = 70_000_000, 32
    assert V * D > 2**31
    g = torch.Generator(device=card).manual_seed(7)
    table = torch.empty(V, D, dtype=torch.bfloat16, device=card)
    table.normal_(generator=g)
    ids = torch.randint(V - 4_000_000, V, (512, 8), generator=g,
                        device=card, dtype=torch.int32)
    ids[:, -1] = -1
    ids[0] = V - 1
    got = embedding_bag(ids, table)
    want = embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.gpu
def test_embedding_bag_kernel_raises_instead_of_falling_back(card):
    ids = torch.zeros(4, 3, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="table on cpu"):
        embedding_bag(ids, torch.ones(5, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedding_bag(ids, torch.ones(5, 8, device=card).half())
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(ids, torch.ones(8, 5, device=card).t())


def _bag_inputs(card, B, L, V, D, dtype, seed):
    """Ids of every kind: padding (-1), below -1, valid, and >= V."""
    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(-3, V + 5, (B, L), generator=g, device=card,
                        dtype=torch.int32)
    table = torch.randn(V, D, generator=g, device=card).to(dtype)
    return ids, table


def _check_bag(ids, table, want_route, out=None):
    """One launch on ``want_route`` (both counts move by one), equal to the
    plain version: 1e-4 in fp32, 1e-2 in bf16 (one rounding of the
    output)."""
    assert bag_route(ids, table, out) == want_route
    before = dict(kernels.LAUNCHES)
    got = embedding_bag(ids, table, out=out)
    torch.cuda.synchronize()
    for key in ("embedding_bag", f"embedding_bag.{want_route}"):
        assert kernels.LAUNCHES.get(key, 0) == before.get(key, 0) + 1, key
    other = "warp" if want_route == "vec" else "vec"
    assert kernels.LAUNCHES.get(f"embedding_bag.{other}", 0) == \
        before.get(f"embedding_bag.{other}", 0)
    tol = 1e-2 if table.dtype == torch.bfloat16 else 1e-4
    want = embedding_bag_ref(ids, table)
    torch.testing.assert_close(got.reshape(want.shape).float(),
                               want.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 8, 13])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_vec_matches_plain_version(card, dtype, D, L):
    """The 16-byte-piece route at 2-32 lanes a bag; L = 13 takes a full
    and a partial chunk of 8 slots; B not a multiple of a block's bags."""
    ids, table = _bag_inputs(card, 1001, L, 4099, D, dtype, D + L)
    _check_bag(ids, table, "vec")


@pytest.mark.gpu
@pytest.mark.parametrize("D,dtype", [(256, torch.float32),
                                     (512, torch.bfloat16)])
def test_embedding_bag_vec_rows_wider_than_a_warp(card, D, dtype):
    """64 pieces a row: each of a bag's 32 lanes sums two pieces, in two
    passes over the bag's slots."""
    ids, table = _bag_inputs(card, 333, 9, 2000, D, dtype, D)
    _check_bag(ids, table, "vec")


@pytest.mark.gpu
def test_embedding_bag_vec_addresses_rows_past_2_to_the_26(card):
    """fp32 [70M, 32] (9 GB): every valid id at or above 2^26, so every
    row's element offset passes 2^31."""
    V, D = 70_000_000, 32
    g = torch.Generator(device=card).manual_seed(3)
    table = torch.empty(V, D, device=card)
    table.normal_(generator=g)
    ids = torch.randint(1 << 26, V, (4096, 8), generator=g, device=card,
                        dtype=torch.int32)
    ids[:, -1] = -1
    ids[0] = V - 1
    assert int(ids[ids >= 0].min()) * D >= 2**31
    _check_bag(ids, table, "vec")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cols,want_route", [
    (torch.float32, 1296, "vec"),    # the deep tower's padded buffer
    (torch.float32, 1293, "warp"),   # unpadded: rows not 16-byte aligned
    (torch.bfloat16, 1296, "vec"),
    (torch.bfloat16, 1293, "warp"),
])
def test_embedding_bag_strided_out_with_a_padded_row(card, dtype, cols,
                                                     want_route):
    """40 bags a row written into the first 1,280 columns of a wider
    buffer; the columns past them keep their bits."""
    B, F, L, V, D = 333, 40, 8, 5000, 32
    ids, table = _bag_inputs(card, B * F, L, V, D, dtype, cols)
    buf = torch.full((B, cols), float("nan"), dtype=dtype, device=card)
    buf[:, F * D:] = 3.0
    rest = buf[:, F * D:].clone()
    view = buf[:, :F * D]
    got = _check_bag(ids, table, want_route, out=view)
    assert got.data_ptr() == view.data_ptr()
    assert torch.equal(buf[:, F * D:], rest)
    assert bool(torch.isfinite(buf[:, :F * D]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 16, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_warp_covers_narrow_and_odd_rows(card, dtype, D):
    """The warp route on a table whose base is one element past 16-byte
    alignment (D = 80 takes three passes over the row's columns)."""
    V = 777
    ids, src = _bag_inputs(card, 300, 11, V, D, dtype, D)
    buf = torch.empty(V * D + 1, dtype=dtype, device=card)
    table = buf[1:].view(V, D)
    table.copy_(src)
    assert table.is_contiguous() and table.data_ptr() % 16
    _check_bag(ids, table, "warp")


@pytest.mark.gpu
def test_embedding_bag_misaligned_base_takes_warp_never_the_plain_version(
        card, monkeypatch):
    """A CUDA tensor reaches a kernel: with the plain version made to
    raise, a misaligned table still launches the warp kernel."""
    ids, src = _bag_inputs(card, 64, 8, 100, 32, torch.float32, 1)
    buf = torch.empty(100 * 32 + 1, device=card)
    table = buf[1:].view(100, 32)
    table.copy_(src)
    want = embedding_bag_ref(ids, table)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(bag_ops, "embedding_bag_ref", refuse)
    before = kernels.LAUNCHES.get("embedding_bag.warp", 0)
    got = embedding_bag(ids, table)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag.warp"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_embedding_bag_route_counts(card):
    """One count under ``embedding_bag`` and one under the route per call,
    whatever the route: 3 vec calls and 2 warp calls."""
    ids, table = _bag_inputs(card, 50, 4, 60, 32, torch.float32, 2)
    odd = torch.randn(60, 6, device=card)
    kernels.reset_launches()
    for _ in range(3):
        embedding_bag(ids, table)
    for _ in range(2):
        embedding_bag(ids, odd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"embedding_bag": 5, "embedding_bag.vec": 3,
                                "embedding_bag.warp": 2}


@pytest.mark.gpu
def test_wide_deep_on_the_card_matches_the_cpu(card):
    """SMOKE in float32 (TF32 off): serve and retrieval forwards on cuda
    (one K4 launch each) equal the plain versions on the cpu, rtol 1e-4 /
    atol 1e-5."""
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = wd.SMOKE
    on_card = recsys.init_params(cfg, torch.Generator(card).manual_seed(0),
                                 device=card)
    on_host = recsys.WideDeep(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    before = kernels.LAUNCHES.get("embedding_bag", 0)
    before_vec = kernels.LAUNCHES.get("embedding_bag.vec", 0)
    for shape in ("serve_p99", "retrieval_cand"):
        spec = wd.SMOKE_SHAPES[shape]
        step = wd.make_step(cfg, spec.kind)
        got = step(on_card, wd.make_batch(cfg, spec, seed=1, device=card))
        want = step(on_host, wd.make_batch(cfg, spec, seed=1, device="cpu"))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert kernels.LAUNCHES["embedding_bag"] == before + 2
    assert kernels.LAUNCHES["embedding_bag.vec"] == before_vec + 2


# ------------------------------------------------ fused chains with K1 inside

CHAIN_QUERIES = [
    ("ic1", "MATCH (p:PERSON)-[:KNOWS*2]-(friend:PERSON) "
            "WHERE p.id = $pid RETURN friend, count(p) AS c "
            "ORDER BY c DESC LIMIT 20", {"pid": 5}),
    ("ic12", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
             "(friend)<-[:HASCREATOR]-(comment:COMMENT), "
             "(comment)-[:REPLYOF]->(post:POST), (post)-[:HASTAG]->(t:TAG), "
             "(t)-[:HASTYPE]->(tc:TAGCLASS) WHERE p.id = $pid "
             "RETURN friend, count(comment) AS cnt "
             "ORDER BY cnt DESC LIMIT 20", {"pid": 5}),
    ("triangle", "Match (a:PERSON)-[:KNOWS]->(b:PERSON)-[:KNOWS]->"
                 "(c:PERSON), (a)-[:KNOWS]->(c) Return count(a) AS t", None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,text,params", CHAIN_QUERIES,
                         ids=[q[0] for q in CHAIN_QUERIES])
def test_fused_chains_on_the_card_match_the_cpu(card, name, text, params):
    """On a small LDBC store the fused chain on cuda (its probes launching
    K1) is row-identical to the loop on cuda and the fused chain on the
    cpu."""
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.ldbc import generate_ldbc
    store = generate_ldbc(sf=0.1, seed=7)
    gc, gh = GOpt(store), GOpt(store, device="cpu")
    oc, oh = gc.optimize(text, params), gh.optimize(text, params)
    gc.execute(oc, params=params)                        # measuring runs
    gh.execute(oh, params=params)
    before = kernels.LAUNCHES.get("wcoj_intersect", 0)
    before_fence = kernels.LAUNCHES.get("wcoj_intersect.fence", 0)
    fused, st = gc.execute(oc, params=params)
    torch.cuda.synchronize()
    assert st.kernels.get("dispatch:fused_chain", 0) >= 1, st.kernels
    probes = st.kernels.get("probe:fused_chain", 0)
    assert kernels.LAUNCHES.get("wcoj_intersect", 0) - before == \
        probes + st.kernels.get("dispatch:intersect", 0)
    # every probe of the path walks its CSR's search index
    assert kernels.LAUNCHES.get("wcoj_intersect.fence", 0) - before_fence \
        == kernels.LAUNCHES.get("wcoj_intersect", 0) - before
    if name == "triangle":
        assert probes >= 1
    loop, _ = gc.execute(oc, params=params, chain_dispatch=False)
    host, sh = gh.execute(oh, params=params)
    assert sh.kernels.get("dispatch:fused_chain", 0) >= 1
    for other in (loop, host):
        assert fused.nrows == other.nrows and set(fused.cols) == \
            set(other.cols)
        for k in fused.cols:
            np.testing.assert_array_equal(np.asarray(fused.cols[k]),
                                          np.asarray(other.cols[k]))


# ------------------------------------------------------------ K1 WCOJ probe

def _probe_args(card, indptr, indices, rows, targets, pos_map=None):
    t = [torch.as_tensor(np.asarray(a, dtype=np.int32)).to(card)
         for a in (indptr, indices, rows, targets)]
    if pos_map is not None:
        pos_map = torch.as_tensor(np.asarray(pos_map, np.int32)).to(card)
    return (*t, pos_map)


def _check_probe(args, index, want_route):
    """One launch on ``want_route`` (both counts move by one, the other
    route's not), equal to the plain version bit for bit."""
    assert wcoj_route(args[1], index) == want_route
    before = dict(kernels.LAUNCHES)
    got = wcoj_intersect(*args, index)
    torch.cuda.synchronize()
    for key in ("wcoj_intersect", f"wcoj_intersect.{want_route}"):
        assert kernels.LAUNCHES.get(key, 0) == before.get(key, 0) + 1, key
    other = "search" if want_route == "fence" else "fence"
    assert kernels.LAUNCHES.get(f"wcoj_intersect.{other}", 0) == \
        before.get(f"wcoj_intersect.{other}", 0)
    want = wcoj_intersect_ref(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fence", "search"])
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("name", sorted(trouble_cases()))
def test_wcoj_routes_match_plain_version(card, name, with_pos, which):
    """Both routes equal the plain version where the fence walk is likely
    to go wrong (``tests/_wcoj_cases.py``), with and without a pos map."""
    indptr, indices, rows, tgt = trouble_cases()[name]
    pos = (np.random.default_rng(1).permutation(indices.shape[0])
           if with_pos else None)
    args = _probe_args(card, indptr, indices, rows, tgt, pos)
    index = build_search_index(args[1]) if which == "fence" else None
    found, _ = _check_probe(args, index, which)
    assert found.any() and not found.all()


@pytest.mark.gpu
def test_wcoj_fence_on_a_180000_degree_row(card):
    """A hub of the synthetic smoke CSR's largest degree (six index levels
    below its start) among rows of every small degree."""
    rng = np.random.default_rng(2)
    deg = rng.integers(0, 12, 400)
    deg[123] = 180_000
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(10 ** 7, d, replace=False))
                              for d in deg])
    rows = np.where(rng.random(1 << 16) < 0.5, 123,
                    rng.integers(0, 400, 1 << 16))
    slot = indptr[rows] + (rng.random(1 << 16) * deg[rows]).astype(np.int64)
    tgt = np.where((rng.random(1 << 16) < 0.5) & (deg[rows] > 0),
                   indices[np.minimum(slot, indices.shape[0] - 1)],
                   rng.integers(0, 10 ** 7, 1 << 16))
    pos = rng.permutation(indices.shape[0])
    args = _probe_args(card, indptr, indices, rows, tgt, pos)
    for index, which in ((build_search_index(args[1]), "fence"),
                         (None, "search")):
        found, _ = _check_probe(args, index, which)
    assert found.any() and not found.all()


@pytest.mark.gpu
def test_wcoj_fence_on_a_csr_past_2_to_the_26(card):
    """2^26 + 5 keys over 2^20 rows of random degree, sorted per row on
    the card: node and level addresses past 2^26 slots."""
    g = torch.Generator(card).manual_seed(3)
    nnz, n_rows, n = (1 << 26) + 5, 1 << 20, 1 << 20
    cuts = torch.randint(0, nnz, (n_rows - 1,), generator=g,
                         device=card).sort().values
    indptr = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), nnz)])
    row = torch.searchsorted(indptr[1:], torch.arange(nnz, device=card),
                             right=True)
    key = torch.randint(0, 1 << 30, (nnz,), generator=g, device=card)
    indices = ((row << 31) | key).sort().values & ((1 << 31) - 1)
    del row, key
    rows = torch.randint(0, n_rows, (n,), generator=g, device=card)
    deg = indptr[rows + 1] - indptr[rows]
    slot = indptr[rows] + (torch.rand(n, generator=g, device=card)
                           * deg).long()
    tgt = torch.where(torch.rand(n, generator=g, device=card) < 0.5,
                      indices[slot.clamp(max=nnz - 1)],
                      torch.randint(0, 1 << 30, (n,), generator=g,
                                    device=card))
    i32 = torch.int32
    args = (indptr.to(i32), indices.to(i32), rows.to(i32), tgt.to(i32), None)
    index = build_search_index(args[1])
    assert index.shape[0] > (1 << 23)
    found, _ = _check_probe(args, index, "fence")
    assert found.any() and not found.all()


@pytest.mark.gpu
def test_wcoj_route_counts(card):
    """One count under ``wcoj_intersect`` and one under the route per
    call: 3 fence calls and 2 search calls."""
    indptr, indices, rows, tgt = trouble_cases()["power_degrees"]
    args = _probe_args(card, indptr, indices, rows, tgt)
    index = build_search_index(args[1])
    kernels.reset_launches()
    for _ in range(3):
        wcoj_intersect(*args, index)
    for _ in range(2):
        wcoj_intersect(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"wcoj_intersect": 5,
                                "wcoj_intersect.fence": 3,
                                "wcoj_intersect.search": 2}


@pytest.mark.gpu
def test_wcoj_misaligned_indices_take_search_never_the_plain_version(
        card, monkeypatch):
    """A CUDA tensor reaches a kernel: with the plain version made to
    raise, an indices view 4 bytes past a sector boundary still launches
    the search kernel, though an index is given."""
    indptr, indices, rows, tgt = trouble_cases()["shared_nodes"]
    args = _probe_args(card, indptr, indices, rows, tgt)
    index = build_search_index(args[1])
    buf = torch.empty(indices.shape[0] + 1, dtype=torch.int32, device=card)
    shifted = buf[1:]
    shifted.copy_(args[1])
    want = wcoj_intersect_ref(*args)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(wcoj_ops, "wcoj_intersect_ref", refuse)
    assert wcoj_route(shifted, index) == "search"
    before = kernels.LAUNCHES.get("wcoj_intersect.search", 0)
    got = wcoj_intersect(args[0], shifted, *args[2:], index)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wcoj_intersect.search"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------ the delta overlay on the card

DELTA_QUERIES = CHAIN_QUERIES + [
    ("knows_edges", "MATCH (a:PERSON)-[k:KNOWS]->(b:PERSON) "
                    "WHERE a.id < 40 RETURN a.id AS aid, b.id AS bid, "
                    "k.creationDate AS d, b.creationDate AS bd "
                    "ORDER BY aid, bid", None),
    ("knows_triangle", "MATCH (p:PERSON)-[:KNOWS]->(a:PERSON), "
                       "(p)-[:KNOWS]->(b:PERSON), (a)-[:KNOWS]->(b) "
                       "WHERE p.id = $pid RETURN count(a) AS n",
     {"pid": 5}),
]


def _mutate(ms, seed=0, n=400):
    """A seeded mix on ``ms``: PERSON inserts (with properties), KNOWS
    inserts among old and new persons (with a creationDate), deletes of
    base KNOWS edges, and two PERSON deletes at the end."""
    rng = np.random.default_rng(seed)
    knows = ("PERSON", "KNOWS", "PERSON")
    t = next(t for t in ms.base.out_csr if t.label == "KNOWS")
    csr = ms.base.out_csr[t]
    lo, hi = ms.base.type_range("PERSON")
    people = list(range(lo, hi))
    for i in range(n):
        k = rng.integers(0, 6)
        if k == 0:
            people.append(ms.insert_vertex("PERSON", {
                "id": 900_000 + i, "creationDate": 1_500_000_000 + i}))
        elif k < 5:
            s, d = (int(x) for x in rng.choice(people, 2))
            try:
                ms.insert_edge(knows, s, d, {"creationDate": 1_600_000 + i})
            except ValueError:          # a tombstoned base edge
                pass
        else:
            p = int(rng.integers(0, csr.nnz))
            r = int(np.searchsorted(csr.indptr, p, side="right") - 1)
            ms.delete_edge(knows, lo + r, int(csr.indices[p]))
    ms.delete_vertex(people[-1])
    ms.delete_vertex(lo + 3)


@pytest.mark.gpu
def test_delta_path_on_the_card_matches_the_cpu(card):
    """On an sf=0.1 mutable store with inserts, tombstones and extension
    vertices, every query on cuda (K1 probing the base CSR and the insert
    and tombstone views, all on ``fence``) is row-identical to the cpu,
    before and after ``compact()``."""
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.delta import MutableGraphStore
    from repro_torch.graphdb.ldbc import generate_ldbc
    ms = MutableGraphStore(generate_ldbc(sf=0.1, seed=7))
    _mutate(ms)
    gc, gh = GOpt(ms), GOpt(ms, device="cpu")
    for what in ("overlay", "compacted"):
        before = dict(kernels.LAUNCHES)
        for name, text, params in DELTA_QUERIES:
            for _ in range(2):                 # measuring run, then fused
                tc, _ = gc.run(text, params)
                th, _ = gh.run(text, params)
                assert tc.nrows == th.nrows, (what, name)
                for k in tc.cols:
                    np.testing.assert_array_equal(
                        np.asarray(tc.cols[k]), np.asarray(th.cols[k]),
                        err_msg=f"{what}/{name}/{k}")
        torch.cuda.synchronize()
        k1 = kernels.LAUNCHES.get("wcoj_intersect", 0) - before.get(
            "wcoj_intersect", 0)
        assert k1 > 0
        assert kernels.LAUNCHES.get("wcoj_intersect.fence", 0) - before.get(
            "wcoj_intersect.fence", 0) == k1
        if what == "overlay":
            gc.compact()
            gh.refresh_stats(rebuild_glogue=True)
            assert gc.glogue.freq == gh.glogue.freq


@pytest.mark.gpu
def test_overlay_property_gathers_on_the_card(card):
    """Extension ids and overlay edge positions through ``vertex_prop`` and
    ``edge_prop`` on cuda: each side's index is clamped before the gather
    (an unclamped ``index_select`` would fire a device-side assert), and
    the values equal the store's host gathers."""
    from repro_torch.graphdb.delta import MutableGraphStore
    from repro_torch.graphdb.ldbc import generate_ldbc
    from repro_torch.graphdb.torch_backend import torch_spec
    ms = MutableGraphStore(generate_ldbc(sf=0.05, seed=7))
    knows = ("PERSON", "KNOWS", "PERSON")
    lo, hi = ms.base.type_range("PERSON")
    g1 = ms.insert_vertex("PERSON", {"id": 901, "creationDate": 7})
    g2 = ms.insert_vertex("PERSON", {"id": 902})
    ms.insert_edge(knows, g1, g2, {"creationDate": 11})
    ms.insert_edge(knows, lo, g1)
    ops = torch_spec().operators(ms)
    ids = np.array([g1, g2, lo, hi - 1, ms.base.n_vertices - 1],
                   dtype=np.int64)
    for prop in ("id", "creationDate", "firstName"):
        got = ops.to_host(ops.vertex_prop(ops.asarray(ids), prop))
        np.testing.assert_array_equal(got, ms.vertex_prop(ids, prop))
    t = next(t for t in ms.base.out_csr if t.label == "KNOWS")
    nb = ms.base.n_edges
    tids = np.full(4, ms.triple_index()[t], dtype=np.int64)
    pos = np.array([0, 5, nb, nb + 1], dtype=np.int64)
    got = ops.to_host(ops.edge_prop(ops.asarray(tids), ops.asarray(pos),
                                    "creationDate"))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, ms.edge_prop(tids, pos,
                                                    "creationDate"))
    assert got[2] == 11


# ------------------------------------------------- the sharded backend (K1)

@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fence", "search"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_block_probes_on_the_card_sum_to_the_whole_probe(card, n_shards,
                                                         which):
    """The sharded backend's rank-local probe (``block_probe``: one K1
    launch on one block, non-owned rows probing -2) on every block of a
    partition, each on the route asked for and equal to the same function
    on CPU tensors (the plain version); the blocks' hits and positions sum
    to the plain probe of the whole CSR."""
    from repro_torch.graphdb.partition import partition_csr
    from repro_torch.graphdb.sharded_backend import block_probe, upload_block
    rng = np.random.default_rng(n_shards)
    deg = rng.integers(0, 40, 600)
    deg[[17, 300]] = (9_000, 70_000)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(10 ** 6, d, replace=False))
                              for d in deg])
    pos = rng.permutation(indices.shape[0])
    rows = rng.integers(0, 600, 1 << 15)
    slot = indptr[rows] + (rng.random(1 << 15) * deg[rows]).astype(np.int64)
    tgt = np.where(rng.random(1 << 15) < 0.5,
                   indices[np.minimum(slot, indices.shape[0] - 1)],
                   rng.integers(-2, 10 ** 6, 1 << 15))
    csr = dataclasses.make_dataclass("C", ["indptr", "indices", "pos"])(
        indptr, indices, pos)
    sh = partition_csr(csr, n_shards)
    i32 = torch.int32
    args = _probe_args(card, indptr, indices, rows, tgt, pos)
    want = wcoj_intersect_ref(*args)
    hits = torch.zeros(rows.shape[0], dtype=i32, device=card)
    epos = torch.zeros_like(hits)
    for r in range(n_shards):
        out = []
        for dev in (card, torch.device("cpu")):
            blk = upload_block(sh, r, lambda a: torch.as_tensor(
                a, dtype=i32).to(dev))
            if which == "fence":
                blk.index = build_search_index(blk.indices)
            if dev.type == "cuda":
                assert wcoj_route(blk.indices, blk.index) == which
            before = kernels.LAUNCHES.get(f"wcoj_intersect.{which}", 0)
            out.append(block_probe(blk, args[2].to(dev), args[3].to(dev)))
            launched = kernels.LAUNCHES.get(f"wcoj_intersect.{which}", 0)
            assert launched == before + (dev.type == "cuda")
        torch.cuda.synchronize()
        for a, b in zip(*out):
            assert torch.equal(a.cpu(), b)
        hits += out[0][0].to(i32)
        epos += out[0][1]
    assert torch.equal(hits > 0, want[0]) and int(hits.max()) == 1
    assert torch.equal(epos, want[1])
    assert want[0].any() and not want[0].all()


@pytest.mark.gpu
def test_sharded_gopt_on_the_card_matches_torch(card):
    """``GOpt(store, backend="sharded", devices=1)`` on cuda: a one-rank
    NCCL group, GLogue and the Appendix-A queries probing through K1 on
    the shard blocks (all on ``fence``), rows identical to the torch spec
    on cuda and to the numpy spec, every expand's collectives recorded."""
    import torch.distributed as dist
    from repro_torch.graphdb.ldbc import generate_ldbc
    from repro_torch.graphdb.sharded_backend import sharded_spec
    store = generate_ldbc(sf=0.1, seed=7)
    before = dict(kernels.LAUNCHES)
    had_group = dist.is_initialized()
    try:
        _sharded_on_the_card(store, before)
    finally:
        # the blocks, and the one-rank NCCL group if the set created it
        sharded_spec(1).release(store)
    assert dist.is_initialized() == had_group


def _sharded_on_the_card(store, before):
    import torch.distributed as dist
    from benchmarks import queries as Q
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.physical_spec import TransferStats
    gs = GOpt(store, backend="sharded", devices=1)
    ops = gs.spec.operators(store)
    assert gs.spec.name == "sharded[1]" and ops.device.type == "cuda"
    assert dist.get_backend(ops.group) == "nccl" and ops.n_shards == 1
    gt = GOpt(store)
    queries = ([(k, v, None) for k, v in Q.QC.items()]
               + [(k, v, Q.QIC_PARAMS[k]) for k, v in Q.QIC.items()])
    for name, text, params in queries:
        opt = gs.optimize(text, params)
        got, st = gs.execute(opt)
        for other in (gt.execute(opt)[0],
                      gs.execute(opt, backend="numpy")[0]):
            assert got.nrows == other.nrows and set(got.cols) == \
                set(other.cols)
            for k in got.cols:
                np.testing.assert_array_equal(np.asarray(got.cols[k]),
                                              np.asarray(other.cols[k]),
                                              err_msg=f"{name}/{k}")
        assert TransferStats.mid_plan_d2h(st.transfers) == 0
        assert "psum:expand_frontier" in st.exchanges
        assert not any(k.startswith("all_gather") for k in st.exchanges)
    torch.cuda.synchronize()
    k1 = kernels.LAUNCHES.get("wcoj_intersect", 0) - before.get(
        "wcoj_intersect", 0)
    assert k1 > 0 and kernels.LAUNCHES.get("wcoj_intersect.fence", 0) \
        - before.get("wcoj_intersect.fence", 0) == k1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gat_cora", "schnet", "nequip",
                                  "equiformer_v2"])
@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_gnn_smoke_bundle_on_the_card_matches_the_cpu(card, arch, shape):
    """Each GNN smoke bundle in float32 (TF32 off): the forward on cuda
    equals the CPU's on the same weights (rtol 1e-3), and one train step
    on cuda moves the weights with a finite loss and gradient norm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pb = importlib.import_module(f"repro_torch.configs.{arch}").bundle(
        smoke=True)
    cfg = pb.model_cfg(shape)
    model, ost, batch = pb.make_concrete(shape, seed=0, device=card)
    on_host = type(model)(cfg, "cpu")
    on_host.load_state_dict(model.state_dict())
    host = {k: torch.as_tensor(v) for k, v in pb.host_batch(shape, 0).items()}
    with torch.no_grad():
        a = pb.module.forward(model, batch, cfg).cpu()
        b = pb.module.forward(on_host, host, cfg)
    torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
    before = [p.detach().clone() for p in model.parameters()]
    model, ost, m = pb.make_step(shape)(model, ost, batch)
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    assert any(not torch.equal(p, q)
               for p, q in zip(model.parameters(), before))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["default", "edge_chunk", "node_chunks"])
def test_equiformer_paths_on_the_card_match_the_cpu(card, path):
    """EquiformerV2's smoke config on ``full_graph_sm`` with its edges
    binned into 4 destination ranges (``bin_edges``), in float32 (TF32
    off), on each message-passing path: the loss and every gradient on
    cuda equal the same path's on the CPU (1e-3 / 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import equiformer_v2 as eq2_cfg
    from repro_torch.models.gnn import equiformer_v2 as eq2
    pb = eq2_cfg.bundle(smoke=True)
    host = pb.host_batch("full_graph_sm", 0)
    N = host["labels"].shape[0]
    host["edges"] = eq2.bin_edges(host["edges"], N, 4)
    E = host["edges"].shape[1]
    kw = {"default": {}, "edge_chunk": {"edge_chunk": E // 4},
          "node_chunks": {"node_chunks": 4}}[path]
    cfg = dataclasses.replace(pb.model_cfg("full_graph_sm"), **kw)
    assert eq2._path(cfg, N, E)[0] == path.split("_")[0]
    model = eq2.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    on_host = type(model)(cfg, "cpu")
    on_host.load_state_dict(model.state_dict())
    grads = []
    for m, dev in ((model, card), (on_host, torch.device("cpu"))):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        loss, _ = eq2.loss_fn(m, batch, cfg)
        loss.backward()
        grads.append([loss.detach().cpu()]
                     + [p.grad.cpu() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_host_staged_set_on_the_card_matches_the_resident_set(card):
    """On a small LDBC store the host-staging baseline over the cuda set
    gives the resident set's rows on the residency sets' 14 queries,
    downloads mid-plan (the resident set does not), and launches K1 once
    a probed slab, every launch on ``fence``."""
    from benchmarks import queries as Q
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.physical_spec import TransferStats
    from repro_torch.graphdb.engine import Engine
    from repro_torch.graphdb.host_staging import HostStagingOperators
    from repro_torch.graphdb.ldbc import generate_ldbc
    store = generate_ldbc(sf=0.1, seed=7)
    gc = GOpt(store)
    staged = HostStagingOperators(gc.spec.operators(store))
    slabs = 0
    for name, text, params in (
            [(k, v, Q.QIC_PARAMS[k]) for k, v in Q.QIC.items()]
            + [(k, v, None) for k, v in Q.QC.items()]):
        opt = gc.optimize(text, params)
        want, rst = gc.execute(opt, params=params)
        before = dict(kernels.LAUNCHES)
        got, st = Engine(store, backend=staged).run(
            opt.logical, opt.physical, params=params)
        torch.cuda.synchronize()
        assert got.nrows == want.nrows and set(got.cols) == set(want.cols)
        for k in got.cols:
            np.testing.assert_array_equal(np.asarray(got.cols[k]),
                                          np.asarray(want.cols[k]),
                                          err_msg=f"{name}/{k}")
        assert TransferStats.mid_plan_d2h(rst.transfers) == 0
        assert TransferStats.mid_plan_d2h(st.transfers) > 0
        n = st.kernels.get("dispatch:intersect", 0)
        for key in ("wcoj_intersect", "wcoj_intersect.fence"):
            assert kernels.LAUNCHES.get(key, 0) - before.get(key, 0) == n
        slabs += n
    assert slabs > 0


# ------------------------------------------------ LM training: the backward

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "prefill", "prefill_ints", "ragged", "chunk", "window_softcap",
    "decode", "g4_hd32", "hd16", "hd128_g2", "keys_past_kv_len",
    "hd128_olmoe"])
def test_attention_backward_kernel_matches_plain_version(card, case, dtype):
    """``flash_attention_bwd`` on the route ``bwd_route`` picks (fp32 and
    bf16 at head_dim 16 or 32 on ``recompute``, bf16 at 64 and 128 on
    ``tc``; counted once) against autograd through the plain version: causal
    prefill (q_start and kv_len as [B] tensors and as ints), a length not a
    multiple of the 64-row tiles, a chunk at q_start > 0, a window with a
    softcap, decode rows, G = 4, head dims 16, 32, 64 and 128, a cache
    longer than kv_len, and OLMoE's layout (G = 1 at head_dim 128, 8 kv
    heads over 640 positions: the bf16 training path's call); 2e-3 in
    fp32, 2e-2 in bf16."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    g = torch.Generator(device=card).manual_seed(len(case))
    B, Sq, Skv, K, G, hd = 2, 256, 256, 2, 1, 64
    window, cap = None, None
    q_start = torch.tensor([0, 0])
    if case == "ragged":
        Sq = Skv = 333
    elif case == "chunk":
        Sq, q_start = 40, torch.tensor([100, 216])
    elif case == "window_softcap":
        Sq = Skv = 300
        window, cap = 70, 5.0
    elif case == "decode":
        Sq, q_start = 1, torch.tensor([17, 255])
    elif case == "g4_hd32":
        G, hd = 4, 32
    elif case == "hd16":
        hd = 16
    elif case == "hd128_g2":
        G, hd, Sq, Skv = 2, 128, 150, 150
    elif case == "keys_past_kv_len":
        Sq, Skv = 100, 300
    elif case == "hd128_olmoe":
        K, hd, Sq, Skv = 8, 128, 640, 640
    kv_len = q_start + Sq
    q = torch.randn(B, Sq, K, G, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Skv, K, hd, generator=g, device=card).to(dtype)
    dout = torch.randn(B, Sq, K, G, hd, generator=g, device=card).to(dtype)
    if case == "prefill_ints":
        q_start, kv_len = 0, Sq
    else:
        q_start, kv_len = q_start.to(card), kv_len.to(card)
    kw = {"window": window, "softcap": cap}
    before = kernels.LAUNCHES.get("flash_attention_bwd", 0)
    got = flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_ref(q, k, v, dout, q_start, kv_len, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    if case == "keys_past_kv_len":
        assert not got[1][:, 200:].any() and not got[2][:, 200:].any()


@pytest.mark.gpu
def test_attention_function_runs_the_backward_kernel(card):
    """Through autograd, a CUDA call runs the forward kernel and then the
    backward kernel, never the plain version."""
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(1, 64, 2, 1, 32, generator=g, device=card,
                    requires_grad=True)
    k = torch.randn(1, 64, 2, 32, generator=g, device=card,
                    requires_grad=True)
    v = torch.randn(1, 64, 2, 32, generator=g, device=card,
                    requires_grad=True)
    before = dict(kernels.LAUNCHES)
    out = flash_attention(q, k, v, 0, 64)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention.rows",
                 "flash_attention_bwd"):
        assert kernels.LAUNCHES[name] == before.get(name, 0) + 1, name
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    want = flash_attention_bwd_ref(q, k, v, 2 * out.detach(), 0, 64)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_attention_backward_raises_instead_of_falling_back(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    q = torch.zeros(1, 4, 2, 1, 24, device=card)
    kv = torch.zeros(1, 4, 2, 24, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, kv, kv, q, 0, 4)
    q = torch.zeros(1, 4, 2, 1, 32, device=card).half()
    kv = torch.zeros(1, 4, 2, 32, device=card).half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_bwd(q, kv, kv, q, 0, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(8, 320, 256, 96), (3, 37, 65, 50),
                                     (4, 640, 64, 128), (2, 1, 1, 1)])
def test_grouped_matmul_backward_matches_plain_version(card, G, M, K, N,
                                                        dtype):
    """The Function's dx and dw: three launches of the kernel (the forward
    and two backward products, each on the route ``route`` picks), against
    autograd through the plain version."""
    x, w = _gmm_operands(card, G, M, K, N, dtype)
    dy = _gmm_operands(card, G, M, N, 1, dtype)[0]
    before = kernels.LAUNCHES.get("grouped_matmul", 0)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(grouped_matmul(xg, wg), (xg, wg), dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_matmul"] == before + 3
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(grouped_matmul_ref(xr, wr), (xr, wr), dy)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("G,M,K,N", [(8, 160, 256, 128),   # OLMoE-like w1
                                     (8, 160, 128, 256),   # and w2
                                     (3, 40, 64, 72)])
def test_grouped_matmul_bf16_backward_runs_on_tc(card, G, M, K, N):
    """In bf16 at widths TMA takes, the Function's forward, dx and dw all
    launch the tensor-core kernel (dx reading w, dw reading x in place
    through the layout flags), and both gradients hold to autograd
    through the plain version at the reference's bf16 tolerance (3e-2)."""
    x, w = _gmm_operands(card, G, M, K, N, torch.bfloat16)
    dy = _gmm_operands(card, G, M, N, 1, torch.bfloat16)[0]
    before = {k: kernels.LAUNCHES.get(k, 0) for k in (
        "grouped_matmul", "grouped_matmul.tc", "grouped_matmul.simt")}
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(grouped_matmul(xg, wg), (xg, wg), dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_matmul"] == before["grouped_matmul"] + 3
    assert (kernels.LAUNCHES["grouped_matmul.tc"]
            == before["grouped_matmul.tc"] + 3)
    assert (kernels.LAUNCHES.get("grouped_matmul.simt", 0)
            == before["grouped_matmul.simt"])
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(grouped_matmul_ref(xr, wr), (xr, wr), dy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.gpu
def test_lm_bf16_train_step_on_masters_takes_the_bf16_routes(card):
    """One train step of a small MoE in bf16 on fp32 masters
    (``master=True``) on the card: K2's forward on ``tc`` 2L times (the
    layer's recompute), its backward L times on ``tc``, K3 12L times on
    ``tc``; the loss and gradient norm finite, every master still fp32 and
    moved; a serving model (bf16 weights) is refused."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    cfg = tfm.TransformerConfig(
        name="tiny-moe-bf16", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=97, moe=True, n_experts=4,
        top_k=2, dtype=torch.bfloat16)
    assert cfg.hd == 64
    model = tfm.init_params(cfg, torch.Generator(card).manual_seed(0),
                            device=card, master=True)
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = tfm.make_train_step(cfg, acfg)
    ost = opt.init(acfg, model.parameters())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 97, (2, 128)),
                           device=card)
    before = [p.detach().clone() for p in model.parameters()]
    kernels.reset_launches()
    model, ost, m = step(model, ost, {"tokens": toks})
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert dict(kernels.LAUNCHES) == {
        "flash_attention": 2 * L, "flash_attention.tc": 2 * L,
        "flash_attention_bwd": L, "flash_attention_bwd.tc": L,
        "grouped_matmul": 12 * L, "grouped_matmul.tc": 12 * L}
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    for p, q in zip(model.parameters(), before):
        assert p.dtype == torch.float32 and not torch.equal(p, q)
    serving = tfm.init_params(cfg, torch.Generator(card).manual_seed(0),
                              device=card)
    with pytest.raises(ValueError, match="master"):
        step(serving, opt.init(acfg, serving.parameters()),
             {"tokens": toks})


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True])
def test_lm_train_step_on_the_card_matches_the_cpu(card, moe):
    """One float32 train step (TF32 off) of a small LM whose head dim the
    kernels take (16): loss, gradient norm and updated weights equal the
    CPU's on the same weights (rtol 2e-3 / atol 2e-4), with the launches
    the code implies: K2 L x 2 forward (the remat recompute) on ``rows``,
    L backward, all on the saved route, K3 L x 12 (MoE) on ``simt``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = tfm.TransformerConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=97, moe=moe, n_experts=4 if moe else 0,
        top_k=2 if moe else 0, dtype=torch.float32)
    on_card = tfm.init_params(cfg, torch.Generator(card).manual_seed(0),
                              device=card)
    on_host = tfm.Transformer(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    toks = np.random.default_rng(0).integers(0, 97, (2, 80))
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = tfm.make_train_step(cfg, acfg)
    out = {}
    for dev, model in ((card, on_card), (torch.device("cpu"), on_host)):
        kernels.reset_launches()
        ost = opt.init(acfg, model.parameters())
        model, ost, m = step(model, ost, {"tokens": torch.as_tensor(
            toks, device=dev)})
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in model.parameters()],
                         dict(kernels.LAUNCHES))
    L = cfg.n_layers
    gmm = 12 * L if moe else 0
    want = {"flash_attention": 2 * L, "flash_attention.rows": 2 * L,
            "flash_attention_bwd": L, "flash_attention_bwd.saved": L}
    if moe:
        want.update({"grouped_matmul": gmm, "grouped_matmul.simt": gmm})
    assert out["cuda"][3] == want and out["cpu"][3] == {}
    for i in (0, 1):
        np.testing.assert_allclose(out["cuda"][i], out["cpu"][i], rtol=2e-3,
                                   atol=2e-4)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


# ------------------- LM training: the saved route and the simt redesign

def _bwd_case(card, case, seed=0):
    """Operands of one attention backward case: (q, k, v, dout, q_start,
    kv_len, options), fp32, the positions as [B] tensors on the card."""
    g = torch.Generator(device=card).manual_seed(seed + len(case))
    B, Sq, Skv, K, G, hd = 2, 200, 200, 2, 1, 64
    q_start, kv_len, kw = [0, 0], None, {}
    if case == "hd16_g4":
        G, hd, Sq, Skv = 4, 16, 77, 77
    elif case == "hd32_g2_window":
        G, hd = 2, 32
        kw = {"window": 33}
    elif case == "hd128_softcap":
        hd, Sq, Skv = 128, 130, 130
        kw = {"softcap": 5.0}
    elif case == "ragged_chunk":
        Sq, Skv, q_start = 45, 301, [100, 256]
    elif case == "short_kv_len":
        Sq, Skv, kv_len = 150, 333, [150, 97]
    elif case == "empty_rows":
        # batch 1's rows sit at 50.. and see no key below its kv_len 20
        # within the window of 8: zero dq, no NaN
        Sq, Skv, q_start, kv_len = 70, 90, [0, 50], [70, 20]
        kw = {"window": 8}
    q_start = torch.tensor(q_start, dtype=torch.int32, device=card)
    kv_len = (q_start + Sq if kv_len is None
              else torch.tensor(kv_len, dtype=torch.int32, device=card))
    q = torch.randn(B, Sq, K, G, hd, generator=g, device=card)
    k = torch.randn(B, Skv, K, hd, generator=g, device=card)
    v = torch.randn(B, Skv, K, hd, generator=g, device=card)
    dout = torch.randn(B, Sq, K, G, hd, generator=g, device=card)
    return q, k, v, dout, q_start, kv_len, kw


BWD_CASES = ["hd64", "hd16_g4", "hd32_g2_window", "hd128_softcap",
             "ragged_chunk", "short_kv_len", "empty_rows"]


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["saved", "recompute"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_backward_routes_match_plain_version(card, case, which):
    """Both routes of the backward kernels against autograd through the
    plain version (2e-3): head dims 16-128, G 1/2/4, lengths that are not
    multiples of the tiles, a window, a softcap, q_start > 0, kv_len <
    Skv, and rows with no admissible key (dq exactly 0 there).  The saved
    route takes the plain forward's output and log-sum-exp."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    q, k, v, dout, q_start, kv_len, kw = _bwd_case(card, case)
    saved = {}
    if which == "saved":
        out, lse = flash_attention_ref(q, k, v, q_start, kv_len,
                                       return_lse=True, **kw)
        saved = {"out": out, "lse": lse}
    before = dict(kernels.LAUNCHES)
    got = flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw, **saved)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd", f"flash_attention_bwd.{which}"):
        assert kernels.LAUNCHES[name] == before.get(name, 0) + 1, name
    want = flash_attention_bwd_ref(q, k, v, dout, q_start, kv_len, **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    if case == "empty_rows":
        assert not got[0][1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_rows_forward_lse_matches_plain_version(card, case):
    """The rows route's log-sum-exp output against the plain version's
    (and its output unchanged by asking for it)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    q, k, v, _, q_start, kv_len, kw = _bwd_case(card, case)
    before = kernels.LAUNCHES.get("flash_attention.rows", 0)
    out, lse = flash_attention_lse(q, k, v, q_start, kv_len, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention.rows"] == before + 1
    want_out, want_lse = flash_attention_ref(q, k, v, q_start, kv_len,
                                             return_lse=True, **kw)
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
    assert torch.equal(out, flash_attention(q, k, v, q_start, kv_len, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hd64", "hd16_g4", "hd32_g2_window",
                                  "hd128_softcap"])
def test_attention_rows_forward_is_bit_equal_over_two_calls(card, case):
    """The rows route's output and log-sum-exp are the same bit for bit
    from call to call (no atomics; the training path's exact resume
    depends on it), and the output the same with or without the
    log-sum-exp."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse
    q, k, v, _, q_start, kv_len, kw = _bwd_case(card, case)
    runs = [flash_attention_lse(q, k, v, q_start, kv_len, **kw)
            for _ in range(2)]
    alone = flash_attention(q, k, v, q_start, kv_len, **kw)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["saved", "recompute"])
def test_attention_backward_is_bit_equal_over_two_runs(card, which):
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_lse)
    q, k, v, dout, q_start, kv_len, kw = _bwd_case(card, "hd32_g2_window")
    saved = {}
    if which == "saved":
        out, lse = flash_attention_lse(q, k, v, q_start, kv_len, **kw)
        saved = {"out": out, "lse": lse}
    runs = [flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw,
                                **saved) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_attention_backward_raises_when_the_launch_fails(card, monkeypatch):
    """A failed launch raises; the plain version is never taken and no
    launch is counted."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, dout, q_start, kv_len, kw = _bwd_case(card, "hd64")
    monkeypatch.setattr(fa_ops, "_bwd_kernel_fn",
                        lambda: (lambda *args: 1))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_ops.flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw)
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("trans_x,trans_w", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("G,M,K,N", [
    (3, 130, 72, 200),        # ragged, 12 wide tiles: 64-wide ones
    (2, 96, 3000, 40),        # 2 wide tiles: 64-wide ones, long K
    (4, 1, 512, 260),         # one row: 64-wide tiles
    (8, 640, 64, 256),        # 80 wide tiles: 64-wide ones
    (2, 33, 1000, 17),        # odd sizes: element-wise loads
    (8, 1280, 256, 512),      # 320 wide tiles
])
def test_grouped_matmul_simt_layouts_match_plain_version(card, G, M, K, N,
                                                         trans_x, trans_w):
    """The simt kernel reading x stored [G, K, M] (trans_x) and w stored
    [G, N, K] (trans_w) in place, on both output tiles, against the plain
    version (1e-4), one launch counted on ``simt``."""
    from repro_torch.kernels.grouped_matmul.ops import simt_tile
    x, w = _gmm_operands(card, G, M, K, N, torch.float32)
    xs = x.transpose(1, 2).contiguous() if trans_x else x
    ws = w.transpose(1, 2).contiguous() if trans_w else w
    before = dict(kernels.LAUNCHES)
    got = grouped_matmul(xs, ws, trans_x=trans_x, trans_w=trans_w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_matmul.simt"] == before.get(
        "grouped_matmul.simt", 0) + 1
    assert kernels.LAUNCHES["grouped_matmul"] == before.get(
        "grouped_matmul", 0) + 1
    assert simt_tile(G, M, N) == (128 if M == 1280 else 64)
    torch.testing.assert_close(got, grouped_matmul_ref(x, w), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("trans_x", [False, True])
def test_grouped_matmul_simt_misaligned_base(card, trans_x):
    """fp32 operands whose base is 4 bytes past 16-byte alignment take the
    element-wise loads of the same kernel, never the plain version."""
    G, M, K, N = 2, 64, 600, 48
    x, w = _gmm_operands(card, G, M, K, N, torch.float32)
    xs = x.transpose(1, 2).contiguous() if trans_x else x
    buf = torch.empty(xs.numel() + 1, device=card)
    shifted = buf[1:].view(xs.shape)
    shifted.copy_(xs)
    assert shifted.data_ptr() % 16 == 4
    before = kernels.LAUNCHES.get("grouped_matmul.simt", 0)
    got = grouped_matmul(shifted, w, trans_x=trans_x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_matmul.simt"] == before + 1
    torch.testing.assert_close(got, grouped_matmul_ref(x, w), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("G,M,K,N", [(4, 1024, 96, 128), (8, 5120, 256, 512)])
def test_grouped_matmul_backward_is_bit_equal_over_two_runs(card, G, M, K,
                                                             N):
    """dx and dw of the same operands, twice: equal bit for bit (dw on
    64-wide tiles over a long K in the first case)."""
    from repro_torch.kernels.grouped_matmul.ops import simt_tile
    assert simt_tile(G, K, N) == 64                  # dw = x^T dy
    x, w = _gmm_operands(card, G, M, K, N, torch.float32)
    dy = _gmm_operands(card, G, M, N, 1, torch.float32)[0]
    runs = []
    for _ in range(2):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        runs.append(torch.autograd.grad(grouped_matmul(xg, wg), (xg, wg),
                                        dy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_grouped_matmul_raises_when_the_launch_fails(card, monkeypatch):
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    x, w = _gmm_operands(card, 2, 8, 16, 8, torch.float32)
    monkeypatch.setattr(gmm_ops, "_kernel_fn",
                        lambda which: (lambda *args: 1))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        gmm_ops.grouped_matmul(x, w)
    assert kernels.LAUNCHES == before


# ------------- bf16 training: K2's tc backward, K3 tc with layout flags

def _tc_bwd_case(card, case, hd, seed=0):
    """bf16 operands of one case of the backward's ``tc`` route: (q, k, v,
    dout, q_start, kv_len, options), the positions [B] int32 on the
    card."""
    g = torch.Generator(device=card).manual_seed(seed + len(case) + hd)
    B, Sq, Skv, K, G = 2, 200, 200, 2, 1
    q_start, kv_len, kw = [0, 0], None, {}
    if case == "g2":
        G = 2
    elif case == "g4_ragged":        # R = 308: not a multiple of 64
        G, Sq, Skv = 4, 77, 77
    elif case == "g8":
        G, Sq, Skv, q_start = 8, 40, 90, [50, 0]
    elif case == "window_softcap50":  # Gemma 2's cap at G 2
        G, Sq, Skv = 2, 300, 300
        kw = {"window": 70, "softcap": 50.0}
    elif case == "softcap5_window1":
        Sq, Skv, kw = 130, 130, {"window": 1, "softcap": 5.0}
    elif case == "chunk":
        Sq, Skv, q_start = 45, 301, [100, 256]
    elif case == "ragged_tiles":     # one past a 128-row and a 64-key tile
        Sq, Skv = 129, 193
    elif case == "short_kv_len":
        Sq, Skv, kv_len = 150, 333, [150, 97]
    elif case == "empty_rows":
        # batch 1's rows sit at 50.. and see no key below its kv_len 20
        # within the window of 8: zero dq, no NaN
        Sq, Skv, q_start, kv_len = 70, 90, [0, 50], [70, 20]
        kw = {"window": 8}
    elif case == "decode":
        Sq, Skv, q_start = 1, 300, [17, 255]
    q_start = torch.tensor(q_start, dtype=torch.int32, device=card)
    kv_len = (q_start + Sq if kv_len is None
              else torch.tensor(kv_len, dtype=torch.int32, device=card))
    q, dout = (torch.randn(B, Sq, K, G, hd, generator=g, device=card)
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Skv, K, hd, generator=g, device=card)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, dout, q_start, kv_len, kw


TC_BWD_CASES = ["causal", "g2", "g4_ragged", "g8", "window_softcap50",
                "softcap5_window1", "chunk", "ragged_tiles", "short_kv_len",
                "empty_rows", "decode"]
BWD_ROUTES = ("tc", "saved", "recompute")


def _past_kv_len(k, kv_len):
    """``[B, Skv, 1, 1]``: the cache rows at or past each slot's kv_len."""
    j = torch.arange(k.shape[1], device=k.device)
    return (j[None] >= kv_len[:, None])[:, :, None, None]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", TC_BWD_CASES)
def test_attention_backward_tc_matches_plain_version(card, case, hd):
    """The ``tc`` route (counted once, there and in the total, on no other
    route) against autograd through the plain version (2e-2): G 1, 2, 4
    and 8, a window with Gemma 2's softcap of 50, a window of 1 with a
    softcap of 5, a chunk at q_start > 0, lengths one past a tile, kv_len
    < Skv, rows with no admissible key (dq exactly 0) and one decode row.
    The cache rows past kv_len hold NaN for the kernel (zeros for the plain
    version, whose einsum would turn 0 * NaN into NaN): the gradients are
    finite, and dk, dv are 0 there."""
    from repro_torch.kernels.flash_attention.ops import (bwd_route,
                                                         flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    q, k, v, dout, q_start, kv_len, kw = _tc_bwd_case(card, case, hd)
    assert bwd_route(q, k, v) == "tc"
    past = _past_kv_len(k, kv_len)
    nan_k, nan_v = (t.masked_fill(past, float("nan")) for t in (k, v))
    before = dict(kernels.LAUNCHES)
    got = flash_attention_bwd(q, nan_k, nan_v, dout, q_start, kv_len, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 1
    for r in BWD_ROUTES:
        name = f"flash_attention_bwd.{r}"
        assert kernels.LAUNCHES.get(name, 0) == before.get(name, 0) + (
            r == "tc"), name
    want = flash_attention_bwd_ref(q, k.masked_fill(past, 0.0),
                                   v.masked_fill(past, 0.0), dout, q_start,
                                   kv_len, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2)
    for grad in got[1:]:
        assert not grad[past.expand_as(grad)].any()
    if case == "empty_rows":
        assert not got[0][1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["causal", "window_softcap50",
                                  "g4_ragged"])
def test_attention_backward_tc_is_bit_equal_over_two_calls(card, case):
    """No atomics: the ``tc`` route's gradients are the same bit for bit
    from call to call (the exact resume of training depends on it)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    q, k, v, dout, q_start, kv_len, kw = _tc_bwd_case(card, case, 128)
    runs = [flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_attention_backward_tc_raises_when_the_launch_fails(card,
                                                            monkeypatch):
    """A failed ``tc`` launch raises; neither the fp32 kernels nor the
    plain version are taken, and no launch is counted."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, dout, q_start, kv_len, kw = _tc_bwd_case(card, "causal", 128)
    monkeypatch.setattr(fa_ops, "_bwd_tc_kernel_fn",
                        lambda: (lambda *args: 1))
    monkeypatch.setattr(fa_ops, "_bwd_kernel_fn", None)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="tc kernel launch failed"):
        fa_ops.flash_attention_bwd(q, k, v, dout, q_start, kv_len, **kw)
    assert kernels.LAUNCHES == before


FLAG_PAIRS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("trans_x,trans_w", FLAG_PAIRS)
@pytest.mark.parametrize("G,M,K,N", [
    (3, 136, 72, 200),        # ragged against 128 x 256 tiles and 64 K
    (2, 40, 520, 88),         # M <= 64: 64 x 64 tiles, ragged K and N
    (4, 200, 1000, 264),      # a row tile of 8 rows past a whole one
    (8, 640, 256, 512),       # OLMoE-like dw at 8 experts
])
def test_grouped_matmul_tc_layouts_match_plain_version(card, G, M, K, N,
                                                       trans_x, trans_w):
    """The tensor-core kernel reading x stored [G, K, M] (trans_x) and w
    stored [G, N, K] (trans_w) in place, at M, N and K that are not
    multiples of its tiles, against the plain version (3e-2), one launch
    counted on ``tc``; the same call twice is equal bit for bit (K is
    summed in order, never split)."""
    x, w = _gmm_operands(card, G, M, K, N, torch.bfloat16)
    xs = x.transpose(1, 2).contiguous() if trans_x else x
    ws = w.transpose(1, 2).contiguous() if trans_w else w
    assert route(xs, ws, trans_x, trans_w) == "tc"
    before = dict(kernels.LAUNCHES)
    got = grouped_matmul(xs, ws, trans_x=trans_x, trans_w=trans_w)
    torch.cuda.synchronize()
    for name, n in (("grouped_matmul", 1), ("grouped_matmul.tc", 1),
                    ("grouped_matmul.simt", 0)):
        assert kernels.LAUNCHES.get(name, 0) == before.get(name, 0) + n
    torch.testing.assert_close(got.float(), grouped_matmul_ref(x, w).float(),
                               rtol=3e-2, atol=3e-2)
    assert torch.equal(got, grouped_matmul(xs, ws, trans_x=trans_x,
                                           trans_w=trans_w))


@pytest.mark.gpu
@pytest.mark.parametrize("trans_x,trans_w,M,K", [(True, False, 36, 64),
                                                 (False, True, 64, 36)])
def test_grouped_matmul_unaligned_stored_inner_takes_simt(card, trans_x,
                                                          trans_w, M, K):
    """bf16 whose stored inner dimension (M of x stored [K, M], K of w
    stored [N, K]) is not a multiple of 8 goes to ``simt``, which reads it
    in place: no copy, no plain version."""
    x, w = _gmm_operands(card, 2, M, K, 48, torch.bfloat16)
    xs = x.transpose(1, 2).contiguous() if trans_x else x
    ws = w.transpose(1, 2).contiguous() if trans_w else w
    assert route(xs, ws, trans_x, trans_w) == "simt"
    before = kernels.LAUNCHES.get("grouped_matmul.simt", 0)
    got = grouped_matmul(xs, ws, trans_x=trans_x, trans_w=trans_w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["grouped_matmul.simt"] == before + 1
    torch.testing.assert_close(got.float(), grouped_matmul_ref(x, w).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("trans_x,trans_w", FLAG_PAIRS[1:])
def test_grouped_matmul_tc_flagged_call_allocates_only_its_output(
        card, trans_x, trans_w):
    """A flagged ``tc`` call grows the memory it asks the caching
    allocator for by its output alone, at its peak too: no transposed copy
    of an operand.  (The bytes requested, not ``memory_allocated``: a
    cached block less than 1 MB larger than a request is handed out
    whole.)"""
    G, M, K, N = 8, 640, 512, 1024
    x, w = _gmm_operands(card, G, M, K, N, torch.bfloat16)
    xs = x.transpose(1, 2).contiguous() if trans_x else x
    ws = w.transpose(1, 2).contiguous() if trans_w else w
    grouped_matmul(xs, ws, trans_x=trans_x, trans_w=trans_w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def requested(which):
        return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]

    base = requested("current")
    out = grouped_matmul(xs, ws, trans_x=trans_x, trans_w=trans_w)
    torch.cuda.synchronize()
    grown = out.numel() * out.element_size()
    assert requested("current") - base == grown
    assert requested("peak") - base == grown


# ------------------------------ K4's backward and Wide & Deep training

def _bag_bwd_case(card, N, L, V, D, seed, G=1, stride=None, hot=0):
    """Ids of every kind (padding, below -1, valid, >= V), ``hot`` slots
    on row 0, and a bag gradient at unit RMS as ``[N / G, G * D]`` rows
    of row stride ``stride`` (a view of a wider buffer)."""
    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(-3, V + 5, (N, L), generator=g, device=card,
                        dtype=torch.int32)
    if hot:
        flat = ids.view(-1)
        where = torch.randperm(N * L, generator=g, device=card)[:hot]
        flat[where] = 0
    cols = G * D
    buf = torch.randn(N // G, stride or cols, generator=g, device=card)
    return ids, buf[:, :cols]


def _check_bag_bwd(ids, grad, V):
    """One ``embedding_bag_bwd`` launch a call, the same bits over two
    calls, within 1e-4 of the plain version run on the fp64 gradient (in
    fp32 its atomics add up to the tolerance's size of error of their own
    on a row of tens of thousands of slots whose terms cancel)."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_backward
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    before = kernels.LAUNCHES.get("embedding_bag_bwd", 0)
    got = embedding_bag_backward(ids, grad, V)
    again = embedding_bag_backward(ids, grad, V)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag_bwd"] == before + 2
    assert got.shape == (V, grad.shape[1] * grad.shape[0] // ids.shape[0])
    assert torch.equal(got, again)
    want = embedding_bag_backward_ref(ids, grad.double(), V)
    assert want.dtype == torch.float64
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,V,D", [(1000, 8, 5000, 32), (37, 3, 50, 8),
                                     (300, 13, 2000, 80), (1, 1, 1, 32)])
def test_embedding_bag_backward_matches_plain_version(card, N, L, V, D):
    ids, grad = _bag_bwd_case(card, N, L, V, D, seed=N + D)
    _check_bag_bwd(ids, grad, V)


@pytest.mark.gpu
def test_embedding_bag_backward_hot_row_and_deep_tower_geometry(card):
    """The shape of Wide & Deep's training at a small batch: 40 bags a
    gradient row of row stride 1,293 floats (5,172 bytes, not 16-byte
    aligned), and one row taking 60,000 slots (~235 chunks, summed as
    partials in chunk order), with padding and ids past the table."""
    B, F, L, V, D = 2048, 40, 8, 100_000, 32
    ids, grad = _bag_bwd_case(card, B * F, L, V, D, seed=1, G=F,
                              stride=1293, hot=60_000)
    assert grad.stride(0) == 1293 and (grad.stride(0) * 4) % 16
    assert int((ids == 0).sum()) >= 60_000
    got, want = _check_bag_bwd(ids, grad, V)
    assert float(want[0].abs().max()) > 10      # the hot row's sum
    untouched = torch.ones(V, dtype=torch.bool, device=card)
    untouched[ids[(ids >= 0) & (ids < V)].long()] = False
    assert bool(untouched.any()) and not bool(got[untouched].any())


@pytest.mark.gpu
def test_embedding_bag_backward_never_runs_the_plain_version(card,
                                                             monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the plain version
    made to raise, the kernel still runs; wrong inputs on the card
    raise."""
    from repro_torch.kernels.embedding_bag import ops
    ids, grad = _bag_bwd_case(card, 64, 4, 100, 32, seed=3)
    want = ops.embedding_bag_backward_ref(ids, grad, 100)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ops, "embedding_bag_backward_ref", refuse)
    got = ops.embedding_bag_backward(ids, grad, 100)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="float32"):
        ops.embedding_bag_backward(ids, grad.half(), 100)
    with pytest.raises(ValueError, match="ids are on"):
        ops.embedding_bag_backward(ids.cpu(), grad, 100)
    with pytest.raises(ValueError, match="dense and apart"):
        ops.embedding_bag_backward(ids, grad.t().contiguous().t(), 100)
    monkeypatch.setattr(ops, "_bwd_fn", lambda: (lambda *args: 1))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.embedding_bag_backward(ids, grad, 100)
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
def test_wide_deep_train_step_on_the_card_matches_the_cpu(card):
    """One float32 train step of Wide & Deep SMOKE (TF32 off) on the
    card and on the CPU from the same weights: loss, gradient norm and
    every updated weight within rtol 1e-4 / atol 1e-5, one K4 forward (on
    ``vec``) and one K4 backward launch on the card, none on the CPU."""
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as opt
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = wd.SMOKE
    spec = wd.SMOKE_SHAPES["train_batch"]
    on_card = recsys.init_params(cfg, torch.Generator(card).manual_seed(0),
                                 device=card)
    on_host = recsys.WideDeep(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                           weight_decay=0.0)
    step = recsys.make_train_step(cfg, acfg)
    out = {}
    for dev, model in ((card, on_card), (torch.device("cpu"), on_host)):
        kernels.reset_launches()
        ost = opt.init(acfg, model.parameters())
        model, ost, m = step(model, ost, wd.make_batch(cfg, spec, seed=2,
                                                       device=dev))
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in model.parameters()],
                         dict(kernels.LAUNCHES))
    assert out["cuda"][3] == {"embedding_bag": 1, "embedding_bag.vec": 1,
                              "embedding_bag_bwd": 1}
    assert out["cpu"][3] == {}
    for i in (0, 1):
        np.testing.assert_allclose(out["cuda"][i], out["cpu"][i], rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_bounded_update_on_the_card_is_bit_equal_to_whole_tensors(card):
    """The AdamW update in pieces of 1,000 elements and of whole tensors,
    three steps on the card: the same bits (parameters and moments)."""
    from repro_torch.train import optimizer as opt
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                          total_steps=10)
    g = torch.Generator(device=card).manual_seed(5)
    shapes = [(), (7,), (300, 33), (5000,), (64, 64)]
    params = [torch.randn(s, generator=g, device=card) for s in shapes]
    runs = []
    for piece in (1000, None):
        ps = [p.clone() for p in params]
        st = opt.init(cfg, ps)
        for i in range(3):
            gg = torch.Generator(device=card).manual_seed(10 + i)
            grads = [3 * torch.randn(s, generator=gg, device=card)
                     for s in shapes]
            _, st, _ = opt.update(cfg, grads, st, ps, piece=piece)
        runs.append(ps + st.mu + st.nu)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------- engine spans and host syncs

def _suite_gopt(scale: float, seed: int):
    """The benchmark's store at a small generator scale, its suite, and
    ``GOpt`` on cuda."""
    from perfbench import bench, harness, system
    spec = bench.load()
    cell = spec["workloads"][0]
    cfg = dict(bench.config(spec, cell["config"]), generator_scale=scale)
    qs = harness.queries()
    suite = [(n, qs[n]["text"], qs[n]["params"])
             for n in bench.traffic(cell["traffic"])["queries"]]
    return system.build(cfg, seed, None).gopt, suite, cfg["max_rows"]


def _warned_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing calls the mode reported."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [w for w in caught if "synchroniz" in str(w.message)]


@pytest.mark.gpu
def test_host_syncs_equal_the_sync_debug_modes_count(card):
    """For each suite query, warm, the syncs ``set_sync_debug_mode``
    reports during one ``GOpt.run`` are the run's ``host_syncs``."""
    gopt, suite, max_rows = _suite_gopt(4.0, 2147483911)
    for _, text, params in suite * 2:  # device caches, chain capacities
        gopt.run(text, params, max_rows=max_rows)
    # the mode's first use reports a sync of its own (torch.cuda, once)
    _warned_syncs(lambda: [gopt.run(t, p, max_rows=max_rows)
                           for _, t, p in suite])
    diffs = {}
    for name, text, params in suite:
        torch.cuda.synchronize()
        (_, st), warned = _warned_syncs(
            lambda: gopt.run(text, params, max_rows=max_rows))
        if len(warned) != st.host_syncs:
            diffs[name] = (len(warned), st.host_syncs, sorted(
                {f"{w.filename}:{w.lineno}" for w in warned}))
    assert not diffs, diffs


@pytest.mark.gpu
def test_a_span_around_a_sleep_kernel_contains_it(card):
    """Spans and the profiler's device events share one clock: a span
    opened before ``torch.cuda._sleep`` and closed after a synchronize
    contains the sleep kernel's device interval."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graphdb.engine import ExecStats
    st = ExecStats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        span = st.open("sleep")
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
        st.close(span)
    kernels_ = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if str(e.device_type()).endswith("CUDA")]
    assert len(kernels_) == 1, kernels_
    (ka, kb), (_, a, b, _) = kernels_[0], st.spans[span]
    assert a <= ka and kb <= b, (a, ka, kb, b)
    assert kb - ka > 0.5 * (b - a)
