"""The port's architecture registry (``repro_torch.configs.get_bundle``)
held against the reference's (``repro.configs.get_bundle``):

- ``list_archs`` equal;
- for every full bundle, every shape and both production meshes (jax's
  ``AbstractMesh`` of 16x16 and 2x16x16, handed to both packages): the
  step's arguments in the reference's tree format
  (``reference_specs(input_specs)``) leaf for leaf against the
  reference's ``input_specs``: the global shape, the dtype (a serving
  step's bf16 where the reference keeps an fp32 master of a bf16 config's
  matmul weight; a train step's exactly the reference's), and
  the per-device shard shape of the port's sharding against jax's
  ``NamedSharding.shard_shape``; the hint tables' names; ``model_flops``;
- the skipped cells: exactly the reference's four; the five bf16
  ``train_4k`` cells run on ``meta`` on both production meshes;
- each smoke bundle's first shape that runs, through the port's step and
  the reference's jitted step on the same weights (``params_from_reference``)
  and inputs: the loss and gradient norm at the training tests' rtol 1e-3 /
  atol 1e-4.  The LM smoke configs compute in bf16, where a routing tie
  flips a token's expert (a jump no tolerance bounds) and the port trains
  nothing: both packages run them with ``dtype`` float32, where
  ``train_4k`` runs; their prefill logits and caches are held too, at
  ``test_torch_transformer.py``'s rtol 2e-3 / atol 2e-4;
- ``shard_hint``, the sharding record, ``run_cell`` on every smoke bundle
  and on the full ``olmoe-1b-7b`` ``decode_32k`` cell.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro.configs import get_bundle as ref_get_bundle
from repro.configs import list_archs as ref_list_archs
from repro_torch.configs import get_bundle, list_archs
from repro_torch.configs.base import (NamedSharding, P, _shardings_like,
                                      reference_specs, tree_leaves)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh as PortAbstractMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.sharding import hint_context, shard_hint
from repro_torch.train import optimizer as opt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BF16_TRAIN_CELLS = {(a, "train_4k") for a in (
    "olmoe-1b-7b", "moonshot-v1-16b-a3b", "qwen2.5-32b", "phi3-medium-14b",
    "gemma2-27b")}
LM_ARCHS = sorted(a for a, _ in BF16_TRAIN_CELLS)
LM_RTOL, LM_ATOL = 2e-3, 2e-4
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4


def test_list_archs_equal_reference():
    assert list_archs() == ref_list_archs()
    assert len(list_archs()) == 10


@pytest.fixture(scope="module")
def ref_bundles():
    return {a: ref_get_bundle(a) for a in ref_list_archs()}


def _ref_leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ref_list_archs())
def test_full_bundle_shardings_match_reference(arch, mesh_name, ref_bundles):
    """Leaf for leaf, every argument of every shape the port runs: global
    shape, dtype and per-device shard shape equal to the reference's."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    port, ref = get_bundle(arch), ref_bundles[arch]
    assert port.shape_names() == ref.shape_names()
    checked = 0
    for shape in port.shape_names():
        assert port.model_flops(shape) == ref.model_flops(shape), shape
        if port.shapes[shape].skip:
            continue
        specs = reference_specs(port.input_specs(shape))
        in_sh, _, hints = port.shardings(mesh, shape)
        r_specs = ref.input_specs(shape)
        r_in, _, r_hints = ref.shardings(mesh, shape)
        assert sorted(hints) == sorted(r_hints), shape
        leaves = tree_leaves(specs)
        r_leaves = _ref_leaves(r_specs)
        shards = _shardings_like(specs, in_sh)
        r_shards = jax.tree.leaves(
            r_in, is_leaf=lambda x: isinstance(x, JaxNamedSharding))
        assert len(leaves) == len(r_leaves) == len(shards) == len(r_shards)
        # a serving model keeps a bf16 config's matmul weights in bf16;
        # a train step's leaves are the reference's fp32 masters
        bf16 = (getattr(getattr(port, "cfg", None), "dtype", None)
                == torch.bfloat16 and port.shapes[shape].kind != "train")
        for i, (leaf, r, sh, rsh) in enumerate(zip(leaves, r_leaves, shards,
                                                   r_shards)):
            where = f"{arch} {shape} leaf {i}"
            assert leaf.shape == tuple(r.shape), where
            want = torch.from_numpy(np.zeros((), r.dtype)).dtype \
                if r.dtype != jnp.bfloat16 else torch.bfloat16
            assert leaf.dtype == want or (
                bf16 and want == torch.float32
                and leaf.dtype == torch.bfloat16), where
            assert sh.shard_shape(leaf.shape) == tuple(
                rsh.shard_shape(r.shape)), where
            checked += 1
    assert checked > 0


def test_skipped_cells_are_the_references_and_the_bf16_train_cells(
        ref_bundles):
    """The skipped cells are exactly the reference's four: the bf16
    ``train_4k`` cells, which the port skipped while it trained float32
    only, now run (the test keeps its name from then)."""
    port = {(a, s) for a in list_archs()
            for s, spec in get_bundle(a).shapes.items() if spec.skip}
    ref = {(a, s) for a, b in ref_bundles.items()
           for s, spec in b.shapes.items() if spec.skip}
    assert len(ref) == 4
    assert port == ref
    assert not port & BF16_TRAIN_CELLS


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_train_cell_runs_on_meta(arch, mesh_name):
    """Each bf16 ``train_4k`` cell through ``run_cell`` on its production
    mesh: OK, a train step on fp32 masters whose arguments are the
    reference's leaves (every parameter and both moments fp32), the K2
    forward and backward counted on meta, and K3 for the MoE configs."""
    r = dryrun.run_cell(arch, "train_4k", mesh_name == "2x16x16")
    assert r["status"] == "OK", r.get("error")
    assert r["kind"] == "train"
    kernels = r["roofline"]["kernels"]
    for name in ("flash_attention", "flash_attention_bwd"):
        assert kernels[name]["flops"] > 0, name
    assert ("grouped_matmul" in kernels) == get_bundle(arch).cfg.moe
    model, ost, _ = get_bundle(arch).input_specs("train_4k")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {t.dtype for t in ost.mu + ost.nu} == {torch.float32}


# ------------------------------------------------------------ smoke twins


def _first_shape(bundle):
    return next(s for s in bundle.shape_names()
                if not bundle.shapes[s].skip)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _smoke_pair(arch):
    """The port's and the reference's smoke bundles; an LM's in float32."""
    port = get_bundle(arch, smoke=True)
    ref = ref_get_bundle(arch, smoke=True)
    if port.family == "lm":
        from repro.configs.lm_common import LMBundle as RefLMBundle
        from repro_torch.configs.lm_common import LMBundle
        port = LMBundle(dataclasses.replace(port.cfg, dtype=torch.float32),
                        smoke=True)
        ref = RefLMBundle(dataclasses.replace(ref.cfg, dtype=jnp.float32),
                          smoke=True)
    return port, ref


def _port_model(port, shape, ref_params):
    if port.family == "lm":
        from repro_torch.models import transformer as tfm
        return tfm.params_from_reference(port.cfg, _np(ref_params),
                                         device="cpu")
    if port.family == "gnn":
        return port.module.params_from_reference(
            port.model_cfg(shape), _np(ref_params), device="cpu")
    from repro_torch.models import recsys as pr
    return pr.params_from_reference(port.cfg, _np(ref_params), device="cpu")


@pytest.mark.parametrize("arch", ref_list_archs())
def test_smoke_bundle_step_matches_reference(arch):
    port, ref = _smoke_pair(arch)
    shape = _first_shape(port)
    assert port.shapes[shape].kind == "train"
    r_args = ref.make_concrete(shape, seed=0)
    r_out = jax.jit(ref.make_step(shape))(*r_args)
    model = _port_model(port, shape, r_args[0])
    if port.family == "gnn":
        batch = {k: torch.as_tensor(v)
                 for k, v in port.host_batch(shape, 0).items()}
    else:
        _, _, batch = port.make_concrete(shape, seed=0, device="cpu")
    for k, v in batch.items():          # the same draws
        np.testing.assert_array_equal(v.numpy(), np.asarray(r_args[2][k]),
                                      err_msg=k)
    ost = opt.init(port.adam_cfg(), model.parameters())
    _, _, metrics = port.make_step(shape)(model, ost, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(r_out[2][key]), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=key)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_lm_prefill_matches_reference(arch):
    port, ref = _smoke_pair(arch)
    r_args = ref.make_concrete("prefill_32k", seed=0)
    r_logits, r_caches = jax.jit(ref.make_step("prefill_32k"))(*r_args)
    model = _port_model(port, "prefill_32k", r_args[0])
    _, tokens, caches = port.make_concrete("prefill_32k", seed=0,
                                           device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(r_args[1]))
    logits, caches = port.make_step("prefill_32k")(model, tokens, caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=LM_RTOL, atol=LM_ATOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(caches[kv].numpy(),
                                   np.asarray(r_caches[kv]), rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=kv)


@pytest.mark.parametrize("arch", ref_list_archs())
def test_run_cell_ok_for_every_smoke_shape(arch):
    """The dry run of every smoke shape that runs on a 1x1 mesh (a smoke
    batch does not divide the production meshes' data axes)."""
    bundle = get_bundle(arch, smoke=True)
    mesh = PortAbstractMesh((1, 1), ("data", "model"))
    for shape in bundle.shape_names():
        rec = dryrun.run_cell(arch, shape, bundle=bundle, mesh=mesh)
        if bundle.shapes[shape].skip:
            assert rec["status"] == "SKIPPED"
            continue
        assert rec["status"] == "OK", rec.get("trace")
        args = bundle.input_specs(shape)
        want = sum(leaf.nbytes for leaf in
                   tree_leaves(reference_specs(args)))
        assert rec["bytes_per_device"]["arguments"] == want
        assert rec["roofline"]["flops"] > 0


def test_run_cell_full_olmoe_decode():
    rec = dryrun.run_cell("olmoe-1b-7b", "decode_32k", multi_pod=False)
    assert rec["status"] == "OK", rec.get("trace")
    assert rec["mesh"] == "16x16"
    r = rec["roofline"]
    # every layer's attention and its three expert products went through
    # the kernels' meta branches
    assert r["kernels"]["flash_attention"]["calls"] == 16
    assert r["kernels"]["grouped_matmul"]["calls"] == 48
    assert rec["hints"]["act_resid"]["calls"] == 17
    assert rec["bytes_per_device"]["temps"] > 0


def test_dryrun_main_exit_code_and_lines(capsys):
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "wide-deep", "--shape", "serve_p99",
                     "--mesh", "single"])
    assert ex.value.code == 0
    out = capsys.readouterr().out
    assert "[OK     ] wide-deep" in out and "1 cells, 0 failures" in out


# ------------------------------------------------------------ the records


def test_shard_hint_is_the_identity_without_a_table():
    x = torch.randn(4, 6)
    assert shard_hint(x, "act_resid") is x
    mesh = PortAbstractMesh((2, 3), ("data", "model"))
    with hint_context({"act_resid": NamedSharding(mesh, P("data"))}) as seen:
        assert shard_hint(x, "act_resid") is x
        assert shard_hint(x, "logits") is x
    assert seen == {"act_resid": {"calls": 1,
                                  "bytes_per_device": 2 * 6 * 4}}
    assert shard_hint(x, "act_resid") is x


@pytest.mark.parametrize("shape,spec", [
    ((32, 64), ("data", "model")), ((32, 64), (("pod", "data"), None)),
    ((30, 64), ("data",)), ((0, 32), (None, "model")), ((3, 5), ()),
    ((4, 5, 32), (None, None, "model")), ((64,), (("data", "model"),)),
    ((16, 16), ("model", "data")), ((8, 4), ("pod", None))])
def test_shard_shape_matches_jax(shape, spec):
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    mine = NamedSharding(make_production_mesh(multi_pod=True), P(*spec))
    try:
        want = JaxNamedSharding(jmesh, JaxP(*spec)).shard_shape(shape)
    except ValueError:
        with pytest.raises(ValueError):
            mine.shard_shape(shape)
        return
    assert mine.shard_shape(shape) == tuple(want)
    # the same on jax's mesh object (the port reads axis names and sizes)
    assert NamedSharding(jmesh, P(*spec)).shard_shape(shape) == tuple(want)


def test_input_specs_allocate_nothing():
    bundle = get_bundle("qwen2.5-32b")
    model, tokens, caches, t = bundle.input_specs("decode_32k")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert tokens.device.type == caches["k"].device.type == "meta"
    assert t == 32767
    specs = reference_specs((model,))[0]
    assert specs["layers"]["attn"]["wq"].shape == (64, 5120, 5120)
    assert dataclasses.is_dataclass(bundle.shapes["decode_32k"])


# the bound chip_smoke.py's long_context phase holds prefill(S - 1) + one
# tick to prefill(S) by (LONG_TICK_BOUND there): about twice the largest
# difference this twin measures, which capacity drops make (the last
# token, last in each expert's queue, may be dropped in the longer
# prefill and never in a one-token tick)
LONG_TICK_BOUND = 2.0


def _tie_argmax(a, b) -> bool:
    """Each vector's argmax is a maximum of the other's, up to one bf16
    step of the logits (chip_smoke.py's ``_tie_argmax``)."""
    ulp = max(float(a.abs().max()), float(b.abs().max())) * 2.0 ** -7
    ia, ib = int(a.argmax()), int(b.argmax())
    return (ia == ib or (float(b[ia]) >= float(b.max()) - ulp
                         and float(a[ib]) >= float(a.max()) - ulp))


@pytest.mark.parametrize("S", [512, 1024])
def test_prefill_then_tick_matches_a_longer_prefill(S):
    """The CPU twin of the smoke's long-context check, on OLMoE's smoke
    bundle in bf16 through ``make_step``: ``prefill(S - 1)`` and one tick
    with token ``S - 1`` against ``prefill(S)``, for three seeds: the same
    argmax (up to a tie) and the max abs logit difference within the
    bound; without capacity drops the two are equal bit for bit."""
    from repro_torch.models import transformer as tfm
    bundle = get_bundle("olmoe-1b-7b", smoke=True)
    cfg = bundle.cfg
    prefill, decode = (bundle.make_step(s)
                       for s in ("prefill_32k", "decode_32k"))
    worst = 0.0
    for seed in range(3):
        model = tfm.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, S)).astype(np.int32))
        full, _ = prefill(model, toks, tfm.init_kv_cache(cfg, 1, S, "cpu"))
        caches = tfm.init_kv_cache(cfg, 1, S, "cpu")
        prefill(model, toks[:, :S - 1], caches)
        tick, _ = decode(model, toks[:, S - 1:], caches, S - 1)
        assert _tie_argmax(full[0].float(), tick[0].float()), seed
        worst = max(worst, float((full.float() - tick.float()).abs().max()))
        if seed == 0:       # no drop: this seed's routing fits
            roomy = dataclasses.replace(cfg, capacity_factor=100.0)
            full, _ = tfm.prefill(model, toks, roomy,
                                  tfm.init_kv_cache(roomy, 1, S, "cpu"))
            caches = tfm.init_kv_cache(roomy, 1, S, "cpu")
            tfm.prefill(model, toks[:, :S - 1], roomy, caches)
            tick, _ = tfm.decode_step(model, toks[:, S - 1:], roomy, caches,
                                      S - 1)
            assert torch.equal(full, tick)
    assert worst <= LONG_TICK_BOUND


def test_base_helpers_match_reference():
    """``dp_axes``, ``zero1``, ``rand_tokens``, ``map_sds``,
    ``replicate_tree``, ``metrics_sharding`` and ``to_torch`` (the
    reference's ``to_jnp``) against the reference's ``configs/base.py``."""
    from repro.configs import base as rb
    from repro_torch.configs import base as pb
    for shape, axes in MESHES.values():
        jmesh = AbstractMesh(shape, axes)
        assert pb.dp_axes(jmesh) == rb.dp_axes(jmesh)
        for spec, leaf in [((None, None, "model"), (12, 768, 2304)),
                           (("model", None), (61, 32)), ((), (16, 7)),
                           ((None, "model"), (3, 48))]:
            want = rb.zero1(JaxP(*spec), leaf, jmesh.shape["data"], jmesh)
            got = pb.zero1(P(*spec), leaf, jmesh.shape["data"], jmesh)
            assert tuple(got) == tuple(want)
    a = pb.rand_tokens(np.random.default_rng(3), (2, 5), 61)
    b = rb.rand_tokens(np.random.default_rng(3), (2, 5), 61)
    np.testing.assert_array_equal(a, b)
    tree = {"w": np.ones((4, 2), np.float32), "b": [np.zeros(3, np.int32)]}
    recs = pb.map_sds(pb.to_torch(tree))
    assert recs == {"w": pb.sds((4, 2), torch.float32),
                    "b": [pb.sds((3,), torch.int32)]}
    mesh = make_production_mesh()
    for fn in (pb.replicate_tree, pb.metrics_sharding):
        shards = fn(mesh, recs)
        assert all(s.shard_shape(r.shape) == r.shape for r, s in zip(
            tree_leaves(recs), tree_leaves(shards)))
