"""Batched molecules from the seed, with their edge geometry (NumPy, on
the host).

A frozen copy of ``random_molecule_batch``, ``edge_geometry`` and
``radial_basis`` of ``src/repro_torch/data/graphs.py`` and of the real
spherical harmonics and Wigner blocks of
``src/repro_torch/models/gnn/spherical.py``, kept here so that the
benchmark's inputs do not move when the program's data modules do.  The
one change: ``random_molecule_batch`` takes any seed that
``numpy.random.default_rng`` takes (the benchmark passes ``[seed, i]``).
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


def packed_wigner_size(l_max: int) -> int:
    return sum((2 * l + 1) ** 2 for l in range(l_max + 1))


def radial_basis(dist: np.ndarray, n_rbf: int, cutoff: float = 5.0) -> np.ndarray:
    """Gaussian radial basis (SchNet-style)."""
    centers = np.linspace(0.0, cutoff, n_rbf)
    gamma = n_rbf / cutoff
    return np.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2).astype(np.float32)


def edge_geometry(coords: np.ndarray, src: np.ndarray, dst: np.ndarray,
                  l_max: int, n_rbf: int) -> dict:
    """Wigner blocks + RBF for edges given 3-D coordinates."""
    vec = coords[src] - coords[dst]
    d = np.linalg.norm(vec, axis=1)
    d = np.maximum(d, 1e-6)
    rot = rotation_to_z(vec / d[:, None])
    wig = pack_wigner(wigner_blocks(l_max, rot))
    return {"wigner": wig.astype(np.float32), "rbf": radial_basis(d, n_rbf)}


def random_molecule_batch(batch: int, n_nodes: int, n_edges: int, n_species: int,
                          l_max: int, n_rbf: int, seed=0) -> dict:
    """Batched small molecules: concatenated graphs + graph_ids readout."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    feats = np.zeros((N, n_species), np.float32)
    feats[np.arange(N), rng.integers(0, n_species, N)] = 1.0
    s0 = rng.integers(0, n_nodes, (batch, n_edges))
    d0 = (s0 + 1 + rng.integers(0, n_nodes - 1, (batch, n_edges))) % n_nodes
    offs = (np.arange(batch) * n_nodes)[:, None]
    src = (s0 + offs).reshape(-1).astype(np.int32)
    dst = (d0 + offs).reshape(-1).astype(np.int32)
    coords = rng.normal(size=(N, 3)) * 2.0
    g = {
        "node_feat": feats,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(E, np.float32),
        "node_mask": np.ones(N, np.float32),
        "graph_ids": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "targets": rng.normal(size=(batch,)).astype(np.float32),
        "graph_mask": np.ones((batch,), np.float32),
    }
    g.update(edge_geometry(coords, src, dst, l_max, n_rbf))
    return g
