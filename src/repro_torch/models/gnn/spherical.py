"""Real spherical harmonics and per-edge Wigner rotation blocks (host side;
the port's own copy of ``repro/models/gnn/spherical.py``).

EquiformerV2's eSCN trick needs, per edge, the rotation of the irrep basis
that aligns the edge direction with +z.  We avoid an e3nn dependency by
computing the real-SH rotation matrices *numerically*: for rotation R and
degree l, D_l(R) is the unique matrix with  Y_l(R r) = D_l(R) Y_l(r)  for all
directions r, so a least-squares fit over K >> 2l+1 sample directions
recovers D_l to ~1e-6.  All of this is data-pipeline featurization (NumPy),
exactly where production GNN systems put geometry preprocessing.  The code
is the JAX package's, line for line, so both packages get the same bits
for the same inputs.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _legendre_assoc(l_max: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_l^m(x) (no Condon-Shortley), shape (L+1, L+1, N)."""
    n = x.shape[0]
    p = np.zeros((l_max + 1, l_max + 1, n))
    p[0, 0] = 1.0
    if l_max == 0:
        return p
    somx2 = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    for m in range(1, l_max + 1):
        p[m, m] = (2 * m - 1) * somx2 * p[m - 1, m - 1]
    for m in range(l_max):
        p[m + 1, m] = (2 * m + 1) * x * p[m, m]
    for m in range(l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[l, m] = ((2 * l - 1) * x * p[l - 1, m] - (l + m - 1) * p[l - 2, m]) / (
                l - m
            )
    return p


def real_sph_harm(l_max: int, dirs: np.ndarray) -> np.ndarray:
    """Real spherical harmonics Y_lm for unit vectors ``dirs`` (N, 3).

    Returns (N, (l_max+1)^2) with the flat index l^2 + l + m, m in [-l, l].
    Uses the orthonormal real basis (geodesy convention)."""
    dirs = np.asarray(dirs, np.float64)
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    phi = np.arctan2(y, x)
    p = _legendre_assoc(l_max, z)
    n = dirs.shape[0]
    out = np.zeros((n, (l_max + 1) ** 2))
    for l in range(l_max + 1):
        for m in range(0, l + 1):
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m)
            )
            if m == 0:
                out[:, l * l + l] = norm * p[l, 0]
            else:
                base = math.sqrt(2.0) * norm * p[l, m]
                out[:, l * l + l + m] = base * np.cos(m * phi)
                out[:, l * l + l - m] = base * np.sin(m * phi)
    return out


@lru_cache(maxsize=8)
def _fit_basis(l_max: int, k: int = 96, seed: int = 0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ys = real_sph_harm(l_max, dirs)  # (K, (L+1)^2)
    pinvs = []
    for l in range(l_max + 1):
        yl = ys[:, l * l : (l + 1) ** 2]  # (K, 2l+1)
        pinvs.append(np.linalg.pinv(yl))  # (2l+1, K)
    return dirs, ys, pinvs


def rotation_to_z(vec: np.ndarray) -> np.ndarray:
    """Rotation matrices R (E,3,3) with R @ v/|v| = +z (Rodrigues)."""
    v = np.asarray(vec, np.float64)
    v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(v, z)
    s = np.linalg.norm(axis, axis=-1)
    c = v @ z
    # degenerate (parallel / antiparallel) handling
    safe = s > 1e-9
    axis = np.where(safe[:, None], axis / np.maximum(s, 1e-12)[:, None], [1.0, 0.0, 0.0])
    angle = np.arctan2(s, c)
    angle = np.where(c < -1.0 + 1e-12, np.pi, angle)
    kx, ky, kz = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = np.zeros_like(kx)
    kmat = np.stack(
        [zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], axis=-1
    ).reshape(-1, 3, 3)
    eye = np.eye(3)[None]
    sa = np.sin(angle)[:, None, None]
    ca = np.cos(angle)[:, None, None]
    return eye + sa * kmat + (1 - ca) * (kmat @ kmat)


def wigner_blocks(l_max: int, rot: np.ndarray) -> list[np.ndarray]:
    """Per-degree real Wigner matrices for rotations ``rot`` (E,3,3).

    Returns [D_0 (E,1,1), D_1 (E,3,3), ..., D_L (E,2L+1,2L+1)] such that
    Y_l(R r) = D_l @ Y_l(r)."""
    dirs, ys, pinvs = _fit_basis(l_max)
    rotated = np.einsum("eij,kj->eki", rot, dirs)  # (E, K, 3)
    e, k = rotated.shape[0], dirs.shape[0]
    ys_rot = real_sph_harm(l_max, rotated.reshape(-1, 3)).reshape(e, k, -1)
    blocks = []
    for l in range(l_max + 1):
        yr = ys_rot[:, :, l * l : (l + 1) ** 2]  # (E, K, 2l+1)
        # D_l = (pinv @ Y_rot)^T  so that  Y_rot = Y @ D^T, i.e. y' = D y
        d = np.einsum("mk,ekn->emn", pinvs[l], yr)  # (E, 2l+1, 2l+1) -> D^T
        blocks.append(np.swapaxes(d, 1, 2).astype(np.float32))
    return blocks


def pack_wigner(blocks: list[np.ndarray]) -> np.ndarray:
    """Pack per-l blocks into (E, sum (2l+1)^2) flat layout."""
    return np.concatenate([b.reshape(b.shape[0], -1) for b in blocks], axis=1)


def wigner_layout(l_max: int) -> list[tuple[int, int]]:
    """(offset, width) of each l's block in the packed layout."""
    out, off = [], 0
    for l in range(l_max + 1):
        w = (2 * l + 1) ** 2
        out.append((off, 2 * l + 1))
        off += w
    return out


def packed_wigner_size(l_max: int) -> int:
    return sum((2 * l + 1) ** 2 for l in range(l_max + 1))
