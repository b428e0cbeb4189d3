"""The port's irrep machinery (``repro_torch.models.gnn.irreps``), the twin
of ``tests/test_irreps.py``: the torch spherical harmonics against the
numpy tables (atol 1e-5) and against the reference's jax version; the
Wigner property and CG equivariance on the port's copies of the tables
(equal to the reference's); ``edge_wigner`` mapping each edge direction to
+z for l = 0..6, and equal to the reference's on the same unit vectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import irreps as ref
from repro_torch.models.gnn import irreps as ir


def _rand_units(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rand_rotation(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def test_sh_torch_matches_numpy_and_reference():
    u = _rand_units(50, 0)
    got = ir.real_sph_harm(6, torch.as_tensor(u, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), ir.real_sph_harm_np(6, u),
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.real_sph_harm(6, jnp.asarray(
            u, jnp.float32))), atol=1e-5)
    np.testing.assert_array_equal(ir.real_sph_harm_np(6, u),
                                  ref.real_sph_harm_np(6, u))


@pytest.mark.parametrize("l", range(7))
def test_wigner_property(l):
    R = _rand_rotation(l + 5)
    u = _rand_units(30, l)
    D = ir.wigner_D_np(l, R)
    Yl = ir.real_sph_harm_np(l, u)[:, l * l:(l + 1) ** 2]
    YRl = ir.real_sph_harm_np(l, u @ R.T)[:, l * l:(l + 1) ** 2]
    np.testing.assert_allclose(YRl, Yl @ D.T, atol=1e-8)
    np.testing.assert_allclose(D @ D.T, np.eye(2 * l + 1), atol=1e-8)
    np.testing.assert_array_equal(ir.Jd_matrix(l), ref.Jd_matrix(l))


@pytest.mark.parametrize("l1,l2,l3", [
    (1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 2, 2), (2, 1, 2),
    (0, 2, 2), (2, 2, 0)])
def test_cg_equivariance(l1, l2, l3):
    C = ir.cg_tensor(l1, l2, l3)
    assert C is not None
    np.testing.assert_array_equal(C, ref.cg_tensor(l1, l2, l3))
    rng = np.random.default_rng(l1 * 7 + l2 * 3 + l3)
    f1 = rng.normal(size=2 * l1 + 1)
    f2 = rng.normal(size=2 * l2 + 1)
    R = _rand_rotation(9)
    D1, D2, D3 = (ir.wigner_D_np(l1, R), ir.wigner_D_np(l2, R),
                  ir.wigner_D_np(l3, R))
    lhs = np.einsum("kij,i,j->k", C, D1 @ f1, D2 @ f2)
    rhs = D3 @ np.einsum("kij,i,j->k", C, f1, f2)
    np.testing.assert_allclose(lhs, rhs, atol=1e-7)


def test_cg_invalid_triple():
    assert ir.cg_tensor(0, 0, 2) is None
    assert ir.cg_tensor(1, 1, 3) is None


@pytest.mark.parametrize("l", range(7))
def test_edge_wigner_aligns_to_z(l):
    """D @ Y_l(rhat) = Y_l(+z) and D is orthogonal; D equals the
    reference's on the same unit vectors; the z-rotation block equals the
    reference's."""
    rhat = _rand_units(5, l + 20)
    D = ir.edge_wigner(l, torch.as_tensor(rhat)).numpy()
    Yl = ir.real_sph_harm_np(l, rhat)[:, l * l:(l + 1) ** 2]
    Yz = ir.real_sph_harm_np(l, np.array([[0., 0., 1.]]))[0,
                                                          l * l:(l + 1) ** 2]
    np.testing.assert_allclose(np.einsum("enm,em->en", D, Yl),
                               np.broadcast_to(Yz, (5, 2 * l + 1)), atol=1e-5)
    eye = np.einsum("enm,ekm->enk", D, D)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(2 * l + 1),
                                                    (5,) * 1 + (2 * l + 1,) * 2),
                               atol=1e-5)
    u32 = rhat.astype(np.float32)
    np.testing.assert_allclose(
        ir.edge_wigner(l, torch.as_tensor(u32)).numpy(),
        np.asarray(ref.edge_wigner(l, jnp.asarray(u32))), atol=1e-5)
    theta = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    np.testing.assert_allclose(
        ir.z_rotation_block(l, torch.as_tensor(theta)).numpy(),
        np.asarray(ref.z_rotation_block(l, jnp.asarray(theta))), atol=1e-6)


def test_edge_wigner_gradient_flows_without_in_place_writes():
    """The z-rotation blocks are stacked, not written in place, so autograd
    can differentiate through an edge frame."""
    rhat = torch.as_tensor(_rand_units(4, 3), dtype=torch.float32)
    rhat.requires_grad_(True)
    ir.edge_wigner(3, rhat).square().sum().backward()
    assert torch.isfinite(rhat.grad).all()
