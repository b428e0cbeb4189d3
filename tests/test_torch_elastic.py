"""The port's elastic restart (``repro_torch.train.elastic``) and meshes
(``repro_torch.launch.mesh``) held against the reference:

- ``reshard`` twins ``tests/test_train_substrate.py::test_elastic_reshard``:
  the reference's tiny LM parameters as host arrays, placed on a ``(1, 1)``
  host mesh (a ``DeviceMesh`` over a one-rank gloo group in this process),
  come back equal; a port state keeps its objects and values;
- a checkpoint written by the reference (its tiny LM after one jitted
  train step, so the moments are not zero) restores in a gloo world of 4
  ranks onto a ``(4, 1)`` mesh, each leaf a DTensor split as the LM
  bundle's training shardings say (ZeRO-1 on the moments); that world
  saves it (gathered), and a world of 2 restores the save onto a ``(2,
  1)`` mesh: every leaf's local shape is its shard shape there, and every
  gathered leaf equals the reference's host array bit for bit;
- the production meshes' axes and sizes, and a host mesh that needs a
  process group.
The worlds run the port only, through ``tests/_sharded_world.py``.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _sharded_world import ELASTIC_CFG, spawn_world
from repro.configs.base import ns as ref_ns
from repro.models import transformer as jt
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ropt
from repro.train.elastic import reshard as ref_reshard
from repro_torch.configs.base import (mesh_axes, ns, reference_specs,
                                      tree_leaves, tree_map)
from repro_torch.configs.lm_common import LMBundle
from repro_torch.launch.mesh import (AbstractMesh, _make_mesh,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train.elastic import reshard


@pytest.fixture(scope="module")
def host_mesh():
    """A ``(1, 1)`` mesh over a one-rank gloo group of this process (the
    group stays, as the sharded backend's in-process groups do)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_host_mesh("cpu")


@pytest.fixture(scope="module")
def ref_tiny():
    cfg = jt.TransformerConfig(**ELASTIC_CFG, dtype=jax.numpy.float32)
    return cfg, jt.init_params(cfg, jax.random.PRNGKey(0))


def test_reshard_host_arrays_on_a_one_device_mesh(host_mesh, ref_tiny):
    """The twin of the reference's test: every leaf equal after."""
    _, params = ref_tiny
    host = jax.tree.map(np.asarray, params)
    out = reshard(host, tree_map(lambda _: ns(host_mesh), host))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    want = ref_reshard(host, jax.tree.map(lambda _: ref_ns(mesh), host))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(out)):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_reshard_keeps_a_port_state_in_place(host_mesh, ref_tiny):
    rcfg, params = ref_tiny
    cfg = tfm.TransformerConfig(**ELASTIC_CFG, dtype=torch.float32)
    model = tfm.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    ost = opt.init(opt.AdamWConfig(), model.parameters())
    before = [p.detach().clone() for p in model.parameters()]
    sh = LMBundle(cfg).shardings(host_mesh, "train_4k")[0][:2]
    out = reshard((model, ost), sh)
    assert out[0] is model and out[1] is ost
    for p, b in zip(model.parameters(), before):
        assert torch.equal(p, b)


def test_checkpoint_sharded_on_4_restores_onto_2(tmp_path, ref_tiny):
    rcfg, params = ref_tiny
    acfg = ropt.AdamWConfig()
    step = jax.jit(jt.make_train_step(rcfg, acfg))
    tokens = np.random.default_rng(0).integers(0, 61, (2, 12)).astype(
        np.int32)
    params, ost, _ = step(params, ropt.init(acfg, params),
                          {"tokens": jax.numpy.asarray(tokens)})
    mgr = ref_ckpt.CheckpointManager(str(tmp_path / "ref_ckpt"),
                                     async_write=False)
    mgr.save(1, (params, ost))
    want = [np.asarray(x) for x in jax.tree.leaves((params, ost))]
    assert np.abs(want[13]).max() > 0           # mu of embed moved

    on4 = spawn_world(4, tmp_path / "w4", ("elastic_save",))
    on2 = spawn_world(2, tmp_path / "w2", ("elastic_restore",))
    cfg = tfm.TransformerConfig(**ELASTIC_CFG, dtype=torch.float32)
    bundle = LMBundle(cfg)
    for world, results in ((4, on4), (2, on2)):
        mesh = AbstractMesh((world, 1), ("data", "model"))
        model = bundle.init_params_abstract()
        specs = tree_leaves(reference_specs(
            (model, bundle.abstract_adam_state(model))))
        shards = tree_leaves(bundle.shardings(mesh, "train_4k")[0][:2])
        local = [sh.shard_shape(leaf.shape)
                 for leaf, sh in zip(specs, shards)]
        assert any(s != leaf.shape for s, leaf in zip(local, specs))
        for res in results:
            key = "elastic_save" if world == 4 else "elastic_restore"
            r = res[key]
            assert r["step"] == 1
            assert r["local_shapes"] == local
            assert len(r["values"]) == len(want)
            for i, (got, w) in enumerate(zip(r["values"], want)):
                np.testing.assert_array_equal(got, w, err_msg=f"leaf {i}")


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert mesh_axes(single) == {"data": 16, "model": 16}
    assert mesh_axes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert single.size == 256 and multi.size == 512
    assert callable(_make_mesh)


def test_host_mesh_is_world_by_one(host_mesh):
    assert mesh_axes(host_mesh) == {"data": dist.get_world_size(),
                                    "model": 1}
    assert host_mesh.device_type == "cpu"
