"""Real-spherical-harmonic irrep machinery (NequIP / EquiformerV2), the port
of ``src/repro/models/gnn/irreps.py``.

The host-numpy tables are the reference's, copied unchanged (the port
imports nothing of the reference): ``real_sph_harm_np``, ``wigner_D_np``,
``cg_tensor`` and ``Jd_matrix``.  The functions that run inside a model
are torch: ``real_sph_harm`` (associated-Legendre recursion unrolled in
Python), ``z_rotation_block`` and ``edge_wigner`` (two analytic
z-rotations conjugated by the numeric quarter-turn ``J``), with the same
ordering (l blocks, m = -l..l), normalisation and angles (``atan2(y, x)``,
then ``arccos(clip(z))``).
"""
from __future__ import annotations

import functools
from math import factorial, pi, sqrt

import numpy as np
import torch


# ------------------------------------------------------------- real SH (np)


def _legendre_all(l_max: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_l^m(x) for 0<=m<=l<=l_max. Returns
    [l_max+1, l_max+1, ...x.shape] with zeros for m>l."""
    P = np.zeros((l_max + 1, l_max + 1) + x.shape, dtype=np.float64)
    P[0, 0] = 1.0
    somx2 = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    for m in range(1, l_max + 1):
        P[m, m] = -(2 * m - 1) * somx2 * P[m - 1, m - 1]
    for m in range(l_max):
        P[m + 1, m] = (2 * m + 1) * x * P[m, m]
    for m in range(l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[l, m] = ((2 * l - 1) * x * P[l - 1, m] -
                       (l + m - 1) * P[l - 2, m]) / (l - m)
    return P


def real_sph_harm_np(l_max: int, u: np.ndarray) -> np.ndarray:
    """Real SH Y[(l,m)] for unit vectors u [..., 3] -> [..., (l_max+1)^2].
    Ordering: l blocks, within block m = -l..l. Orthonormal on the sphere."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    phi = np.arctan2(y, x)
    P = _legendre_all(l_max, z)
    out = np.zeros(u.shape[:-1] + ((l_max + 1) ** 2,), dtype=np.float64)
    for l in range(l_max + 1):
        base = l * l + l
        for m in range(0, l + 1):
            norm = sqrt((2 * l + 1) / (4 * pi) *
                        factorial(l - m) / factorial(l + m))
            if m == 0:
                out[..., base] = norm * P[l, 0]
            else:
                out[..., base + m] = (sqrt(2) * norm * P[l, m]
                                      * np.cos(m * phi))
                out[..., base - m] = (sqrt(2) * norm * P[l, m]
                                      * np.sin(m * phi))
    return out


def real_sph_harm(l_max: int, u: torch.Tensor) -> torch.Tensor:
    """Real SH of unit vectors ``u [..., 3]`` -> ``[..., (l_max+1)^2]``
    (same ordering and normalisation as the numpy twin)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    phi = torch.atan2(y, x)
    P = {(0, 0): torch.ones_like(z)}
    somx2 = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * somx2 * P[(m - 1, m - 1)]
    for m in range(l_max):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] -
                         (l + m - 1) * P[(l - 2, m)]) / (l - m)
    cols = []
    for l in range(l_max + 1):
        block = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            norm = sqrt((2 * l + 1) / (4 * pi) *
                        factorial(l - m) / factorial(l + m))
            if m == 0:
                block[l] = norm * P[(l, 0)]
            else:
                block[l + m] = sqrt(2) * norm * P[(l, m)] * torch.cos(m * phi)
                block[l - m] = sqrt(2) * norm * P[(l, m)] * torch.sin(m * phi)
        cols.extend(block)
    return torch.stack(cols, dim=-1)


# --------------------------------------------------- numeric Wigner (np)


def _rand_units(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def wigner_D_np(l: int, R: np.ndarray, n_samples: int = 0) -> np.ndarray:
    """Real-basis Wigner matrix: Y_l(R u) = D Y_l(u), via lstsq."""
    n = n_samples or (4 * (2 * l + 1))
    u = _rand_units(n, seed=l + 17)
    A = real_sph_harm_np(l, u)[:, l * l:(l + 1) ** 2]          # [n, 2l+1]
    B = real_sph_harm_np(l, u @ R.T)[:, l * l:(l + 1) ** 2]    # [n, 2l+1]
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Equivariant coupling tensor C [2l3+1, 2l1+1, 2l2+1] (unique up to
    sign/scale; normalized to unit Frobenius norm), or None when the triple
    violates |l1-l2|<=l3<=l1+l2."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(l1 * 100 + l2 * 10 + l3)
    rows = []
    for _ in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        D1, D2, D3 = (wigner_D_np(l1, R), wigner_D_np(l2, R),
                      wigner_D_np(l3, R))
        # constraint: D3 @ C == C @ (D1 (x) D2)  for all R
        K = np.kron(D1, D2)                       # [d1*d2, d1*d2]
        M = np.kron(np.eye(d1 * d2), D3) - np.kron(K.T, np.eye(d3))
        rows.append(M)
    M = np.concatenate(rows, axis=0)
    _, s, vh = np.linalg.svd(M)
    null = vh[-1]
    C = null.reshape(d1 * d2, d3).T.reshape(d3, d1, d2)
    if s[-1] > 1e-8:
        return None  # no equivariant map (shouldn't happen for valid triples)
    C = C / np.linalg.norm(C)
    # fix sign deterministically
    idx = np.unravel_index(np.argmax(np.abs(C)), C.shape)
    if C[idx] < 0:
        C = -C
    return C


@functools.lru_cache(maxsize=None)
def Jd_matrix(l: int) -> np.ndarray:
    """Conjugation matrix J_l = D_l(R_yz) where R_yz swaps y and z axes
    (rotation by pi/2 about x, composed per e3nn convention). With this,
    D(rot_z(a) rot_y(b) rot_z(c)) = Z(a) J Z(b) J Z(c)."""
    # rotation by +pi/2 about the x-axis maps (x,y,z)->(x,-z,y)
    R = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    # e3nn's Jd is for the involution; we build the two-sided identity below
    # directly from this quarter-turn: Ry(b) = Rx(-pi/2) Rz(b) Rx(pi/2)
    return wigner_D_np(l, R)


def z_rotation_block(l: int, theta: torch.Tensor) -> torch.Tensor:
    """Analytic real-SH z-rotation matrix ``[*theta.shape, 2l+1, 2l+1]`` for
    one l: m=0 fixed; (m,-m) pairs rotate by m*theta (cos -> +m, sin -> -m,
    as ``real_sph_harm``).  Built by stacking its entries, so no tensor that
    autograd saved is written in place."""
    d = 2 * l + 1
    zero = torch.zeros_like(theta)
    rows = [[zero] * d for _ in range(d)]
    rows[l][l] = torch.ones_like(theta)
    for m in range(1, l + 1):
        c, s = torch.cos(m * theta), torch.sin(m * theta)
        # Y'_{+m} = cos(m t) Y_{+m} - sin(m t) Y_{-m}
        # Y'_{-m} = sin(m t) Y_{+m} + cos(m t) Y_{-m}
        rows[l + m][l + m] = c
        rows[l + m][l - m] = -s
        rows[l - m][l + m] = s
        rows[l - m][l - m] = c
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def edge_wigner(l: int, rhat: torch.Tensor) -> torch.Tensor:
    """Per-edge real Wigner matrix ``[E, 2l+1, 2l+1]`` rotating the frame so
    the edge direction maps to +z: D = (J^T Z(-b) J) Z(-a) with (a, b) the
    azimuth and polar angles of rhat; applied to features as D @ f (world
    frame -> edge frame)."""
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    a = torch.atan2(y, x)
    b = torch.arccos(torch.clamp(z, -1.0, 1.0))
    J = torch.as_tensor(Jd_matrix(l), dtype=rhat.dtype, device=rhat.device)
    Za = z_rotation_block(l, -a)
    Zb = z_rotation_block(l, -b)
    D_y = torch.einsum("nm,...mk,kl->...nl", J.T, Zb, J)
    return torch.einsum("...nm,...mk->...nk", D_y, Za)


def irrep_slices(l_max: int) -> list[slice]:
    return [slice(l * l, (l + 1) ** 2) for l in range(l_max + 1)]
