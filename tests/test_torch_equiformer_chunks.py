"""EquiformerV2's chunked message passing in the port
(``models/gnn/equiformer_v2.py``: ``node_chunks`` and ``edge_chunk``) held
against the reference's same paths on the same weights
(``params_from_reference``) and numpy batches, and against the port's
default path: the reference's binned fixture (``tests/test_perf_variants.py``),
an unbinned batch whose misplaced edges both packages drop under
``node_chunks``, a node-class batch with padded edges and a destination
range with no edge, the settings the reference's rule sends to the default
path (bit-equal to it), one train step of each chunked path, and what the
backward keeps under ``node_chunks``.  Output 1e-4 / 1e-5, gradients
1e-3 / 1e-5, float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import equiformer_v2 as jeq2
from repro.train import optimizer as jopt
from repro_torch.models.gnn import equiformer_v2 as peq2
from repro_torch.models.gnn.nequip import embed_scalars
from repro_torch.train import optimizer as popt

OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
# the reference's fixture config (tests/test_perf_variants.py)
BASE = dict(n_layers=2, d_hidden=16, l_max=3, n_heads=4, n_rbf=8)
CHUNKED = {"edge_chunk": {"edge_chunk": 16}, "node_chunks": {"node_chunks": 4}}


def _binned_batch():
    """The reference's ``eq_batch``: 32 atoms, 64 edge slots in 4 bins of
    16, bin c holding (up to 16) edges aimed at nodes [8c, 8c + 8)."""
    rng = np.random.default_rng(0)
    N, E = 32, 64
    nch, Ec = 4, E // 4
    raw = rng.integers(0, N, (2, 48))
    binned = np.full((2, E), -1, np.int64)
    for c in range(nch):
        sel = (raw[1] >= c * 8) & (raw[1] < (c + 1) * 8)
        es = raw[:, sel][:, :Ec]
        binned[:, c * Ec:c * Ec + es.shape[1]] = es
    return {"atom_type": rng.integers(0, 5, N).astype(np.int32),
            "positions": (rng.normal(size=(N, 3)) * 2).astype(np.float32),
            "edges": binned, "graph_ids": np.zeros(N, np.int32),
            "energy": np.asarray([1.0], np.float32)}


def _unbinned_batch():
    """The same atoms with 64 edges drawn anywhere: under ``node_chunks =
    4`` most edges lie outside their chunk's range."""
    b = _binned_batch()
    rng = np.random.default_rng(1)
    return dict(b, edges=rng.integers(0, 32, (2, 64)).astype(np.int64))


def _node_class_batch():
    """32 nodes with features, 48 edges in 4 bins of 12 (bins 1 and 3 part
    padded with -1), no edge aimed at nodes [16, 24) (bin 2 empty)."""
    rng = np.random.default_rng(2)
    N, nch, Ec = 32, 4, 12
    edges = np.full((2, nch * Ec), -1, np.int64)
    for c, n in ((0, 12), (1, 9), (3, 5)):
        edges[0, c * Ec:c * Ec + n] = rng.integers(0, N, n)
        edges[1, c * Ec:c * Ec + n] = rng.integers(c * 8, c * 8 + 8, n)
    labels = rng.integers(0, 4, N).astype(np.int32)
    labels[-3:] = -1
    return {"node_feat": rng.normal(size=(N, 12)).astype(np.float32),
            "positions": (rng.normal(size=(N, 3)) * 2).astype(np.float32),
            "edges": edges, "labels": labels,
            "train_mask": (rng.random(N) < 0.7).astype(np.float32)}


# the node-class form at l_max 2 (one compile fewer irreps a path)
NODE_CLASS = dict(BASE, l_max=2, d_feat=12, task="node_class", n_classes=4)
BATCHES = {"binned": (_binned_batch, BASE),
           "unbinned": (_unbinned_batch, BASE),
           "node_class": (_node_class_batch, NODE_CLASS)}


def _flat(tree, prefix=()):
    """A reference tree as {port parameter name: array}: the stacked layer
    leaves split into ``layers.<i>.``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    elif prefix[0] == "layers":
        for i in range(tree.shape[0]):
            yield ".".join(("layers", str(i)) + prefix[1:]), tree[i]
    else:
        yield ".".join(prefix), tree


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _params(kw):
    return jeq2.init_params(jeq2.EquiformerV2Config(**kw),
                            jax.random.PRNGKey(0))


ADAM = dict(lr=1e-3, total_steps=10000, weight_decay=0.0)
_REF_FNS = {}


def _ref_fn(kw: dict, step: bool):
    """The reference's forward, loss and gradients (and, with ``step``, its
    ``make_train_step`` from fresh AdamW state) as one jit program taking
    ``(params, batch)``, compiled once a config: batches of one shape share
    it."""
    key = (tuple(sorted(kw.items())), step)
    if key not in _REF_FNS:
        cfg = jeq2.EquiformerV2Config(**kw)
        jac = jopt.AdamWConfig(**ADAM)
        train_step = jeq2.make_train_step(cfg, jac)

        def run(p, jb):
            out = jeq2.forward(p, jb, cfg)
            (loss, _), grads = jax.value_and_grad(
                lambda q: jeq2.loss_fn(q, jb, cfg), has_aux=True)(p)
            if not step:
                return out, loss, grads, None
            return out, loss, grads, train_step(p, jopt.init(jac, p), jb)
        _REF_FNS[key] = jax.jit(run)
    return _REF_FNS[key]


def _ref(batch, kw, params, step=False):
    """The reference's output, loss and gradients by port name (and its
    train step's new weights by port name and metrics)."""
    out, loss, grads, st = _ref_fn(kw, step)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    run = {"out": np.asarray(out), "loss": float(loss),
           "grads": {n: np.asarray(g) for n, g in _flat(grads)}}
    if st is not None:
        run["step"] = (dict(_flat(jax.tree.map(np.asarray, st[0]))),
                       {k: float(v) for k, v in st[2].items()})
    return run


def _port(batch, kw, params):
    """The port's output, loss and gradients by name on the reference's
    weights."""
    cfg = peq2.EquiformerV2Config(**kw)
    model = peq2.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                       device="cpu")
    tb = _tensors(batch)
    out = peq2.forward(model, tb, cfg)
    loss, _ = peq2.loss_fn(model, tb, cfg)
    loss.backward()
    return {"out": out.detach().numpy(), "loss": float(loss.detach()),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def runs():
    """Lazily computed runs, keyed by (package, batch, path); the
    reference's runs at the fixture's config carry its train step (so the
    binned and the unbinned batch share one program)."""
    cache, params = {}, {}

    def get(pkg, batch, path):
        key = (pkg, batch, path)
        if key not in cache:
            make, kw = BATCHES[batch]
            if batch not in params:
                params[batch] = _params(kw)
            step = kw is BASE
            kw = dict(kw, **CHUNKED.get(path, {}))
            cache[key] = (_ref(make(), kw, params[batch], step=step)
                          if pkg == "ref" else _port(make(), kw, params[batch]))
        return cache[key]
    return get


def _close(got, want):
    assert got["out"].shape == want["out"].shape
    np.testing.assert_allclose(got["out"], want["out"], rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


@pytest.mark.parametrize("against", ["reference", "port_default"])
@pytest.mark.parametrize("path", list(CHUNKED))
def test_binned_fixture_matches(runs, path, against):
    """On the reference's binned fixture each chunked path gives the
    reference's same path and the port's default path."""
    want = (runs("ref", "binned", path) if against == "reference"
            else runs("port", "binned", "default"))
    _close(runs("port", "binned", path), want)


def test_unbinned_node_chunks_drop_the_same_edges(runs):
    """Edges aimed outside their chunk's range are dropped by both
    packages, so the result is the reference's and not the default
    path's."""
    got = runs("port", "unbinned", "node_chunks")
    _close(got, runs("ref", "unbinned", "node_chunks"))
    default = runs("port", "unbinned", "default")
    assert not np.allclose(got["out"], default["out"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("path", list(CHUNKED))
def test_node_class_with_padding_and_an_empty_range(runs, path):
    _close(runs("port", "node_class", path), runs("ref", "node_class", path))
    _close(runs("port", "node_class", path),
           runs("port", "node_class", "default"))


@pytest.mark.parametrize("kw", [
    {"edge_chunk": 64},          # E > edge_chunk fails
    {"edge_chunk": 24},          # E % edge_chunk != 0
    {"node_chunks": 3},          # N % node_chunks != 0 (and E's)
    {"node_chunks": 32},         # N divides, E % node_chunks != 0
], ids=["edge_chunk_is_E", "edge_chunk_not_dividing",
        "node_chunks_not_dividing_N", "node_chunks_not_dividing_E"])
def test_settings_the_reference_sends_to_the_default_path(kw):
    """The reference's conditions: a setting that fails its own takes the
    default path, bit for bit (E = 64 edges over N = 32 atoms; with 32
    node chunks, 48 edges)."""
    batch = _binned_batch()
    if kw.get("node_chunks") == 32:
        batch["edges"] = batch["edges"][:, :48]
    cfg = peq2.EquiformerV2Config(**BASE, **kw)
    base = peq2.EquiformerV2Config(**BASE)
    E = batch["edges"].shape[1]
    assert peq2._path(cfg, 32, E) == ("default",)
    model = peq2.init_params(base, torch.Generator().manual_seed(0),
                             device="cpu")
    tb = _tensors(batch)
    outs = []
    for c in (cfg, base):
        model.zero_grad(set_to_none=True)
        loss, _ = peq2.loss_fn(model, tb, c)
        loss.backward()
        outs.append([loss.detach()] + [p.grad.clone()
                                       for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("path", list(CHUNKED))
def test_train_step_matches_reference(runs, path):
    """One ``make_train_step`` step of each chunked path against the
    reference's step on the same weights and binned batch: loss, gradient
    norm, learning rate, and the new weights within two steps' size (at
    step 1 AdamW moves each weight by about the learning rate)."""
    want, jm = runs("ref", "binned", path)["step"]
    kw = dict(BASE, **CHUNKED[path])
    cfg = peq2.EquiformerV2Config(**kw)
    model = peq2.params_from_reference(
        cfg, jax.tree.map(np.asarray, _params(BASE)), device="cpu")
    pac = popt.AdamWConfig(**ADAM)
    model, ost, pm = peq2.make_train_step(cfg, pac)(
        model, popt.init(pac, model.parameters()), _tensors(_binned_batch()))
    assert int(ost.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4,
                                   err_msg=k)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=2 * jm["lr"], err_msg=n)


@pytest.mark.parametrize("path", ["node_chunks", "default"])
def test_node_chunks_save_no_edge_sized_tensor(path):
    """What one layer's backward keeps: under ``node_chunks`` every chunk
    body runs under its own checkpoint, so no tensor saved for backward
    holds ``E x d_hidden x dim`` elements or more; the default path saves
    such tensors (the messages), which shows the check bites."""
    kw = dict(BASE, **CHUNKED.get(path, {}))
    cfg = peq2.EquiformerV2Config(**kw)
    batch = _tensors(_binned_batch())
    model = peq2.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    args = peq2.layer_inputs(batch, cfg)
    x = embed_scalars(model, batch, cfg, 32).detach().requires_grad_()
    E = batch["edges"].shape[1]
    limit = E * cfg.d_hidden * cfg.dim
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = peq2._layer(x, model.layers[0], *args)
        out.square().sum().backward()
    assert saved and torch.isfinite(x.grad).all()
    if path == "default":
        assert max(saved) >= limit
    else:
        assert max(saved) < limit, (max(saved), limit)


@pytest.mark.parametrize("nch", [4, 8])
def test_binned_node_chunks_equal_the_default_path(nch):
    """``bin_edges`` keeps every real edge, each group inside its range,
    and ``node_chunks`` over the binned batch gives the default path over
    the batch as drawn (the same sums in another order)."""
    rng = np.random.default_rng(3)
    batch = _binned_batch()
    edges = rng.integers(0, 32, (2, 80))
    edges[:, ::9] = -1
    binned = peq2.bin_edges(edges, 32, nch)
    real = edges[:, (edges >= 0).all(0)]
    kept = binned[:, (binned >= 0).all(0)]
    assert binned.shape[1] % nch == 0
    assert sorted(map(tuple, kept.T)) == sorted(map(tuple, real.T))
    cap, Nc = binned.shape[1] // nch, 32 // nch
    for c in range(nch):
        d = binned[1, c * cap:(c + 1) * cap]
        d = d[d >= 0]
        assert ((d >= c * Nc) & (d < (c + 1) * Nc)).all()
    cfg = peq2.EquiformerV2Config(**BASE, node_chunks=nch)
    model = peq2.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with torch.no_grad():
        got = peq2.forward(model, _tensors(dict(batch, edges=binned)), cfg)
        want = peq2.forward(model, _tensors(dict(batch, edges=edges)),
                            peq2.EquiformerV2Config(**BASE))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
