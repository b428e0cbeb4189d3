"""The port's GNN family (``repro_torch.models.gnn``, ``repro_torch.configs``
GNN bundles) held against the reference on the same weights
(``params_from_reference``) and the same numpy-seeded batches: for GAT,
SchNet, NequIP and EquiformerV2 in their node-class and their energy (for
GAT: atom-embedding) forms, the forward output, the loss and the gradient
of every parameter (``jax.grad`` against ``backward()``).  Forward
tolerances rtol 1e-4 / atol 1e-5 (GAT, SchNet) and 1e-3 / 1e-4 (NequIP,
EquiformerV2), gradients 1e-3 / 1e-5, float32 throughout.  Then the
twins of ``test_models.py``'s GNN invariance tests, the segment softmax
on empty segments, the bundles (configs, shapes, parameter shapes at full
width, FLOP counts, concrete batches) against the reference's, one train
step of every smoke bundle against the reference's step (EquiformerV2's
chunked paths: ``test_torch_equiformer_chunks.py``).  The smoke bundles
on cuda against the CPU
are in ``test_torch_kernels_gpu.py``, which imports no jax and so runs on
a machine with a card and no jax."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as j_eq2_cfg
from repro.configs import gat_cora as j_gat_cfg
from repro.configs import nequip as j_nequip_cfg
from repro.configs import schnet as j_schnet_cfg
from repro.models.gnn import common as jcommon
from repro.models.gnn import equiformer_v2 as jeq2
from repro.models.gnn import gat as jgat
from repro.models.gnn import nequip as jnequip
from repro.models.gnn import schnet as jschnet
from repro_torch.configs import equiformer_v2 as p_eq2_cfg
from repro_torch.configs import gat_cora as p_gat_cfg
from repro_torch.configs import nequip as p_nequip_cfg
from repro_torch.configs import schnet as p_schnet_cfg
from repro_torch.models.gnn import common
from repro_torch.models.gnn import equiformer_v2 as peq2
from repro_torch.models.gnn import gat as pgat
from repro_torch.models.gnn import nequip as pnequip
from repro_torch.models.gnn import schnet as pschnet
from repro_torch.train import optimizer as opt

FWD_TOL = {"gat": (1e-4, 1e-5), "schnet": (1e-4, 1e-5),
           "nequip": (1e-3, 1e-4), "equiformer_v2": (1e-3, 1e-4)}
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
ARCHS = {  # name -> (reference module, port module, config class name)
    "gat": (jgat, pgat, "GATConfig"),
    "schnet": (jschnet, pschnet, "SchNetConfig"),
    "nequip": (jnequip, pnequip, "NequIPConfig"),
    "equiformer_v2": (jeq2, peq2, "EquiformerV2Config"),
}
# small widths (the test_models.py configs, a feature projection or atom
# types, and two graphs for the energy readout)
SMALL = {"gat": dict(n_heads=2, d_hidden=4),
         "schnet": dict(n_rbf=16, d_hidden=16),
         "nequip": dict(n_layers=2, d_hidden=8),
         "equiformer_v2": dict(n_layers=2, d_hidden=8, l_max=3, n_heads=2,
                               n_rbf=8)}
FORMS = {"node_class": dict(d_feat=12, n_classes=4),
         "energy": dict(n_graphs=2)}
BUNDLES = {  # arch id -> (ARCHS name, reference config, port config)
    "gat-cora": ("gat", j_gat_cfg, p_gat_cfg),
    "schnet": ("schnet", j_schnet_cfg, p_schnet_cfg),
    "nequip": ("nequip", j_nequip_cfg, p_nequip_cfg),
    "equiformer-v2": ("equiformer_v2", j_eq2_cfg, p_eq2_cfg)}
MODEL_CLASS = {"gat": pgat.GAT, "schnet": pschnet.SchNet,
               "nequip": pnequip.NequIP, "equiformer_v2": peq2.EquiformerV2}


def _cfg_kwargs(arch, form):
    kw = dict(SMALL[arch], **FORMS[form])
    if arch == "gat":
        # GAT's second form is the molecule one: atom types, node classes
        kw = (dict(SMALL[arch], d_feat=0, n_atom_types=10, n_classes=5)
              if form == "energy" else dict(SMALL[arch], **FORMS[form]))
    elif form == "node_class":
        kw["task"] = "node_class"
    return kw


def _configs(arch, form):
    jm, pm, name = ARCHS[arch]
    kw = _cfg_kwargs(arch, form)
    return getattr(jm, name)(**kw), getattr(pm, name)(**kw)


def _node_batch(seed=0):
    """40 nodes (the last 4 padded: no edges, label -1), 128 edges (the
    last 8 padded)."""
    rng = np.random.default_rng(seed)
    N, E = 40, 128
    edges = rng.integers(0, N - 4, size=(2, E)).astype(np.int32)
    edges[:, -8:] = -1
    labels = rng.integers(0, 4, size=N).astype(np.int32)
    labels[-4:] = -1
    return {"node_feat": rng.normal(size=(N, 12)).astype(np.float32),
            "edges": edges, "labels": labels,
            "train_mask": (rng.random(N) < 0.6).astype(np.float32),
            "positions": (rng.normal(size=(N, 3)) * 2).astype(np.float32)}


def _molecule_batch(seed=0):
    """Two graphs of 15 atoms and 30 edges each, 2 padded nodes
    (``graph_ids`` -1) and 4 padded edges."""
    rng = np.random.default_rng(seed)
    G, n, e = 2, 15, 30
    N, E = G * n + 2, G * e + 4
    edges = np.full((2, E), -1, np.int32)
    edges[:, :G * e] = (rng.integers(0, n, size=(2, G * e))
                        + np.repeat(np.arange(G), e)[None] * n)
    graph_ids = np.full(N, -1, np.int32)
    graph_ids[:G * n] = np.repeat(np.arange(G), n)
    return {"atom_type": rng.integers(0, 10, size=N).astype(np.int32),
            "positions": (rng.normal(size=(N, 3)) * 2).astype(np.float32),
            "edges": edges, "graph_ids": graph_ids,
            "labels": rng.integers(0, 5, size=N).astype(np.int32),
            "energy": rng.normal(size=G).astype(np.float32)}


def _flat(tree, prefix=()):
    """A reference tree as {dotted name: numpy array} (the port's
    ``named_parameters`` names)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield ".".join(prefix), tree


def _port_layout(arch, cfg, tree):
    """EquiformerV2's reference tree stacks its layers on axis 0; the
    port's has one entry a layer."""
    if arch != "equiformer_v2":
        return tree
    def entry(a, i):
        if isinstance(a, jax.ShapeDtypeStruct):
            return jax.ShapeDtypeStruct(a.shape[1:], a.dtype)
        return a[i]
    return dict(tree, layers=[jax.tree.map(lambda a: entry(a, i),
                                           tree["layers"])
                              for i in range(cfg.n_layers)])


def _tensors(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[
    (a, f) for a in ARCHS for f in FORMS], ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both packages on one case: the reference's output, loss and
    gradients, the port's module (reference weights), output, loss and
    gradients by name."""
    arch, form = request.param
    jm, pm, _ = ARCHS[arch]
    jc, pc = _configs(arch, form)
    batch = _node_batch() if form == "node_class" else _molecule_batch()
    params = jm.init_params(jc, jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout, ((jloss, _), jgrad) = jax.jit(lambda p: (
        jm.forward(p, jb, jc),
        jax.value_and_grad(lambda q: jm.loss_fn(q, jb, jc),
                           has_aux=True)(p)))(params)
    model = pm.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    tb = _tensors(batch)
    pout = pm.forward(model, tb, pc)
    ploss, _ = pm.loss_fn(model, tb, pc)
    ploss.backward()
    return {"arch": arch, "jout": np.asarray(jout), "jloss": float(jloss),
            "jgrad": {n: np.asarray(g) for n, g in
                      _flat(_port_layout(arch, jc, jgrad))},
            "pout": pout.detach().numpy(), "ploss": float(ploss.detach()),
            "pgrad": {n: p.grad.numpy() for n, p in model.named_parameters()}}


def test_forward_matches_reference(pair):
    rtol, atol = FWD_TOL[pair["arch"]]
    assert pair["pout"].shape == pair["jout"].shape
    np.testing.assert_allclose(pair["pout"], pair["jout"], rtol=rtol,
                               atol=atol)


def test_loss_matches_reference(pair):
    rtol, atol = FWD_TOL[pair["arch"]]
    assert np.isfinite(pair["ploss"])
    np.testing.assert_allclose(pair["ploss"], pair["jloss"], rtol=rtol,
                               atol=atol)


def test_every_gradient_matches_reference(pair):
    assert set(pair["pgrad"]) == set(pair["jgrad"])
    for name, want in pair["jgrad"].items():
        np.testing.assert_allclose(pair["pgrad"][name], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


# ------------------------------------------- twins of test_models.py's GNNs

@pytest.fixture(scope="module")
def geo_batch():
    """``test_models.py::geo_batch``: 30 atoms, 64 edges, the last 4 -1."""
    rng = np.random.default_rng(0)
    N, E = 30, 64
    pos = rng.normal(size=(N, 3)) * 2
    edges = rng.integers(0, N, size=(2, E))
    edges[:, -4:] = -1
    return {"atom_type": torch.as_tensor(rng.integers(0, 5, size=N)),
            "positions": torch.as_tensor(pos, dtype=torch.float32),
            "edges": torch.as_tensor(edges),
            "graph_ids": torch.zeros(N, dtype=torch.int32),
            "energy": torch.tensor([1.0])}


def _rotation(seed=3):
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return torch.as_tensor(R, dtype=torch.float32)


def _port_model(mod, cfg, seed=0):
    return mod.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")


@pytest.mark.parametrize("mod,cfg", [
    (pschnet, pschnet.SchNetConfig(n_rbf=16, d_hidden=16)),
    (pnequip, pnequip.NequIPConfig(n_layers=2, d_hidden=8)),
    (peq2, peq2.EquiformerV2Config(n_layers=1, d_hidden=8, l_max=3,
                                   n_heads=2, n_rbf=8)),
], ids=["schnet", "nequip", "equiformer_v2"])
@torch.no_grad()
def test_rotation_invariance(mod, cfg, geo_batch):
    model = _port_model(mod, cfg)
    R = _rotation()
    e1 = mod.forward(model, geo_batch, cfg)
    e2 = mod.forward(model, dict(geo_batch,
                                 positions=geo_batch["positions"] @ R.T), cfg)
    torch.testing.assert_close(e1, e2, rtol=1e-3, atol=1e-4)


@torch.no_grad()
def test_translation_invariance(geo_batch):
    cfg = pnequip.NequIPConfig(n_layers=2, d_hidden=8)
    model = _port_model(pnequip, cfg)
    e1 = pnequip.forward(model, geo_batch, cfg)
    e2 = pnequip.forward(model, dict(geo_batch,
                                     positions=geo_batch["positions"] + 5.0),
                         cfg)
    torch.testing.assert_close(e1, e2, rtol=1e-3, atol=1e-4)


@torch.no_grad()
def test_gat_padding_immune():
    """Extra -1 padded edges must not change outputs."""
    rng = np.random.default_rng(0)
    cfg = pgat.GATConfig(d_feat=8, n_classes=3)
    model = _port_model(pgat, cfg)
    feat = torch.as_tensor(rng.normal(size=(10, 8)).astype(np.float32))
    edges = torch.as_tensor(rng.integers(0, 10, size=(2, 20)).astype(
        np.int32))
    b1 = {"node_feat": feat, "edges": edges}
    b2 = {"node_feat": feat,
          "edges": torch.cat([edges, torch.full((2, 13), -1,
                                                dtype=torch.int32)], dim=1)}
    torch.testing.assert_close(pgat.forward(model, b1, cfg),
                               pgat.forward(model, b2, cfg), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_with_empty_segments(masked):
    """Segments 1 and 4 get no edge (and segment 3 only masked ones): the
    port's softmax equals the reference's, with finite values and zero
    weight on masked edges."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(9, 3)).astype(np.float32) * 5
    seg = np.array([0, 0, 2, 2, 2, 3, 3, 5, 5], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 0, 0, 1, 1], bool)[:, None]
    m = mask if masked else None
    want = np.asarray(jcommon.segment_softmax(
        jnp.asarray(logits), jnp.asarray(seg), 6,
        mask=None if m is None else jnp.asarray(m)))
    got = common.segment_softmax(
        torch.as_tensor(logits), torch.as_tensor(seg).long(), 6,
        mask=None if m is None else torch.as_tensor(m)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if masked:
        assert (got[~mask[:, 0]] == 0).all()
    mx = common.segment_max(torch.as_tensor(logits),
                            torch.as_tensor(seg).long(), 6)
    assert torch.isinf(mx[[1, 4]]).all() and (mx[[1, 4]] < 0).all()


@pytest.mark.parametrize("name", ["gaussian_rbf", "bessel_rbf"])
def test_radial_bases_match_reference(name):
    d = np.linspace(0.0, 6.0, 25).astype(np.float32)
    """The bases and the cutoff envelope at the forward tolerance of GAT
    and SchNet (the envelope's terms cancel: ~28 x^6 - 48 x^7 + 21 x^8)."""
    want = np.asarray(getattr(jcommon, name)(jnp.asarray(d), 16, 5.0))
    got = getattr(common, name)(torch.as_tensor(d), 16, 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        common.poly_cutoff(torch.as_tensor(d), 5.0).numpy(),
        np.asarray(jcommon.poly_cutoff(jnp.asarray(d), 5.0)), rtol=1e-4,
        atol=1e-5)


def test_scatter_mean_and_gather_dense_scatter_match_reference():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(12, 4)).astype(np.float32)
    seg = rng.integers(0, 5, size=12).astype(np.int32)
    mask = rng.random(12) < 0.7
    np.testing.assert_allclose(
        common.scatter_mean(torch.as_tensor(v), torch.as_tensor(seg).long(),
                            6, torch.as_tensor(mask)).numpy(),
        np.asarray(jcommon.scatter_mean(jnp.asarray(v), jnp.asarray(seg), 6,
                                        jnp.asarray(mask))),
        rtol=1e-6, atol=1e-7)
    edges = rng.integers(0, 12, size=(2, 20)).astype(np.int32)
    edges[:, -3:] = -1
    w = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        common.gather_dense_scatter(torch.as_tensor(v), torch.as_tensor(w),
                                    torch.as_tensor(edges), 12).numpy(),
        np.asarray(jcommon.gather_dense_scatter(
            jnp.asarray(v), jnp.asarray(w), jnp.asarray(edges), 12)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ bundles

def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("arch", list(BUNDLES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_bundle_matches_reference(arch, smoke):
    """Shapes, configs, optimizer config, FLOP counts and batch specs of
    every shape equal the reference's; so do the parameter names and
    shapes (the reference's abstractly, the port's on the meta device)."""
    name, jmod, pmod = BUNDLES[arch]
    jb, pb = jmod.bundle(smoke=smoke), pmod.bundle(smoke=smoke)
    assert pb.shape_names() == jb.shape_names()
    assert {k: dataclasses.asdict(v) for k, v in pb.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jb.shapes.items()}
    assert dataclasses.asdict(pb.adam_cfg()) == dataclasses.asdict(
        jb.adam_cfg())
    for shape in jb.shape_names():
        jc, pc = jb.model_cfg(shape), pb.model_cfg(shape)
        assert _asdict(pc) == _asdict(jc), shape
        assert pb.model_flops(shape) == jb.model_flops(shape)
        assert {k: (tuple(s), np.dtype(dt))
                for k, (s, dt) in pb._batch_specs(shape).items()} == \
            {k: (v.shape, np.dtype(v.dtype))
             for k, v in jb._batch_specs(shape).items()}
        ref = jax.eval_shape(lambda r: jb.module.init_params(jc, r),
                             jax.random.PRNGKey(0))
        ref = dict(_flat(_port_layout(name, jc, ref)))
        model = MODEL_CLASS[name](pc, "meta")
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
            {n: tuple(a.shape) for n, a in ref.items()}, shape
        if name == "gat":
            assert pc.param_count() == sum(
                int(np.prod(a.shape)) for a in ref.values())


@functools.lru_cache(maxsize=None)
def _ref_concrete(arch, shape, seed):
    """The reference smoke bundle's ``make_concrete`` (params, optimizer
    state, batch), drawn once per worker."""
    return BUNDLES[arch][1].bundle(smoke=True).make_concrete(shape,
                                                             seed=seed)


@pytest.mark.parametrize("arch", list(BUNDLES))
@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_make_concrete_batch_matches_reference(arch, shape):
    pb = BUNDLES[arch][2].bundle(smoke=True)
    want = _ref_concrete(arch, shape, 0)[2]
    model, ost, got = pb.make_concrete(shape, seed=0, device="cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert int(ost.step) == 0
    assert len(ost.mu) == len(list(model.parameters()))


@pytest.mark.parametrize("arch", list(BUNDLES))
@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_smoke_step_matches_reference(arch, shape):
    """One train step of each smoke bundle through ``make_step``: a finite
    loss, the parameters changed, and the loss, the gradient norm, the
    learning rate and the new parameters equal to the reference's step on
    the same weights and batch (the new parameters within two steps'
    size: at step 1 AdamW moves each weight by about the learning
    rate)."""
    name, jmod, pmod = BUNDLES[arch]
    jb, pb = jmod.bundle(smoke=True), pmod.bundle(smoke=True)
    params, ost, batch = _ref_concrete(arch, shape, 0)
    jp, _, jm = jax.jit(jb.make_step(shape))(params, ost, batch)
    cfg = pb.model_cfg(shape)
    model = pb.module.params_from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pst = opt.init(pb.adam_cfg(), model.parameters())
    tb = _tensors(pb.host_batch(shape, seed=0))
    model, pst, pm = pb.make_step(shape)(model, pst, tb)
    assert int(pst.step) == 1
    assert torch.isfinite(pm["loss"]) and float(pm["loss"]) > 0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    lr = float(jm["lr"])
    want = {n: np.asarray(a) for n, a in _flat(_port_layout(name, cfg, jp))}
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2 * lr, err_msg=n)
        # a weight the loss does not reach (the last layer's gates of the
        # l > 0 blocks, which the scalar readout ignores) stays, as there
        if torch.equal(p.detach(), before[n]):
            np.testing.assert_array_equal(want[n], before[n].numpy(), n)
        moved += not torch.equal(p.detach(), before[n])
    assert moved > 0


def test_equiformer_compression_groups_are_the_reference_leaves():
    """Under int8 compression each leaf of the reference's tree has one
    scale.  EquiformerV2's layers are stacked there and unstacked here, so
    its train step groups ``layers.<i>.<rest>`` by ``rest``: one group a
    reference leaf, shape for shape (the per-tensor scale would round
    each layer on its own)."""
    jc, pc = _configs("equiformer_v2", "energy")
    params = jeq2.init_params(jc, jax.random.PRNGKey(0))
    model = peq2.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                       device="cpu")
    ps = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    groups = opt.stacked_leaves(model)
    assert sorted(i for g in groups for i in g) == list(range(len(ps)))
    got = sorted(((len(g),) if names[g[0]].startswith("layers.") else ())
                 + tuple(ps[g[0]].shape) for g in groups)
    want = sorted(tuple(np.shape(x)) for x in jax.tree.leaves(params))
    assert got == want
