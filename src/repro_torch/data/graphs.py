"""Graph featurization and neighbor sampling (NumPy, host side; the port's
own copy of ``repro/data/graphs.py``).

Produces the static-shape graph dicts the EquiformerV2 model consumes:
  node_feat (N, d_in), edge_src/edge_dst (E,), wigner (E, packed),
  rbf (E, n_rbf), edge_mask (E,), node_mask (N,), labels/targets.

The fanout sampler implements GraphSAGE-style layered uniform sampling over
a CSR adjacency (minibatch_lg requires it).  The code is the JAX package's,
line for line: for the same seeds every array is the same, bit for bit,
``rng.choice`` draws included.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.gnn.spherical import (
    pack_wigner,
    packed_wigner_size,
    rotation_to_z,
    wigner_blocks,
)


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


# ---------------------------------------------------------------------------
# synthetic graphs
# ---------------------------------------------------------------------------

def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 l_max: int, n_rbf: int, seed: int = 0, coords_dim: int = 3) -> dict:
    """Random graph with synthetic 3-D coordinates (non-geometric datasets
    like cora/ogbn get synthetic geometry — DESIGN.md §7)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # no self-loops: a zero-length edge has no direction (undefined frame)
    dst = ((src + 1 + rng.integers(0, n_nodes - 1, n_edges)) % n_nodes).astype(np.int32)
    coords = rng.normal(size=(n_nodes, 3)).astype(np.float64)
    g = {
        "node_feat": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(n_edges, np.float32),
        "node_mask": np.ones(n_nodes, np.float32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }
    g.update(edge_geometry(coords, src, dst, l_max, n_rbf))
    return g


def random_molecule_batch(batch: int, n_nodes: int, n_edges: int, n_species: int,
                          l_max: int, n_rbf: int, seed: int = 0) -> dict:
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


# ---------------------------------------------------------------------------
# CSR adjacency + layered fanout sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    coords: np.ndarray  # (N, 3)
    feats: np.ndarray  # (N, d)
    labels: np.ndarray  # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def random_csr_graph(n_nodes: int, avg_degree: int, d_feat: int,
                     n_classes: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    degrees = rng.poisson(avg_degree, n_nodes).clip(1)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    rows = np.repeat(np.arange(n_nodes), degrees)
    # neighbors != self (zero-length edges have no geometric frame)
    indices = ((rows + 1 + rng.integers(0, n_nodes - 1, indptr[-1])) % n_nodes).astype(
        np.int32
    )
    return CSRGraph(
        indptr=indptr,
        indices=indices,
        coords=rng.normal(size=(n_nodes, 3)),
        feats=rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
    )


def fanout_sample(
    graph: CSRGraph,
    seed_nodes: np.ndarray,
    fanouts: tuple[int, ...],
    l_max: int,
    n_rbf: int,
    rng: np.random.Generator,
    pad_nodes: int | None = None,
    pad_edges: int | None = None,
) -> dict:
    """Layered uniform neighbor sampling (GraphSAGE).  Returns a subgraph in
    the model's format with *local* indices, padded to static shapes.

    Edge direction: sampled neighbor -> seed (messages flow to seeds)."""
    node_ids = list(seed_nodes)
    local = {int(v): i for i, v in enumerate(seed_nodes)}
    src_l, dst_l = [], []
    frontier = list(seed_nodes)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = graph.indptr[v], graph.indptr[v + 1]
            nbrs = graph.indices[lo:hi]
            if len(nbrs) == 0:
                continue
            take = rng.choice(nbrs, size=min(f, len(nbrs)), replace=False)
            for u in take:
                u = int(u)
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                src_l.append(local[u])
                dst_l.append(local[int(v)])
            nxt.extend(int(u) for u in take)
        # dedup: each unique node is expanded once per layer (GraphSAGE)
        frontier = list(dict.fromkeys(nxt))
    node_ids = np.asarray(node_ids, np.int64)
    src = np.asarray(src_l, np.int32)
    dst = np.asarray(dst_l, np.int32)
    n, e = len(node_ids), len(src)
    pn = pad_nodes or n
    pe = pad_edges or e
    if n > pn or e > pe:
        # truncate (rare with sane pads); keep earliest — seeds first
        keep = (src < pn) & (dst < pn)
        src, dst = src[keep][:pe], dst[keep][:pe]
        node_ids = node_ids[:pn]
        n, e = pn, len(src)
    geo = edge_geometry(graph.coords[node_ids], src, dst, l_max, n_rbf)
    out = {
        "node_feat": np.zeros((pn, graph.feats.shape[1]), np.float32),
        "edge_src": np.zeros((pe,), np.int32),
        "edge_dst": np.zeros((pe,), np.int32),
        "edge_mask": np.zeros((pe,), np.float32),
        "node_mask": np.zeros((pn,), np.float32),
        "labels": np.zeros((pn,), np.int32),
        "wigner": np.zeros((pe, packed_wigner_size(l_max)), np.float32),
        "rbf": np.zeros((pe, n_rbf), np.float32),
    }
    out["node_feat"][:n] = graph.feats[node_ids]
    out["edge_src"][:e] = src
    out["edge_dst"][:e] = dst
    out["edge_mask"][:e] = 1.0
    # loss only on seed nodes
    out["node_mask"][: len(seed_nodes)] = 1.0
    out["labels"][:n] = graph.labels[node_ids]
    out["wigner"][:e] = geo["wigner"]
    out["rbf"][:e] = geo["rbf"]
    return out


# ---------------------------------------------------------------------------
# seeded batches for the graph cells (the port's; the JAX package has none)
# ---------------------------------------------------------------------------

def cell_batch(kind: str, template: dict, l_max: int, n_rbf: int,
               seed: int = 0, workers: int = 1) -> dict:
    """A seeded global batch for a graph cell, at the shapes of its
    template (``launch/steps.build_cell``'s ``abstract_args[4]``: anything
    with ``.shape``), laid out as the regime's batch spec cuts it over
    ``workers``:

    * ``graph_full``: one random graph, whole on every worker;
    * ``graph_minibatch``: each worker's padded fanout sample (fanouts
      (2, 2) from 8 seeds) of one CSR graph, local ids, in worker order;
    * ``graph_full_large``: one graph whose nodes are cut into worker
      blocks; worker ``w``'s edges end in its block, ``edge_src`` global
      and ``edge_dst`` local to the block;
    * ``graph_molecule``: ``random_molecule_batch``, global ids (the train
      driver rebases them per worker)."""
    n, d_in = template["node_feat"].shape
    e = template["edge_src"].shape[0]
    if kind == "graph_molecule":
        b = template["targets"].shape[0]
        return random_molecule_batch(b, n // b, e // b, d_in, l_max, n_rbf,
                                     seed=seed)
    n_classes = 2  # labels only need to be in range of any head
    if kind == "graph_full":
        g = random_graph(n, e, d_in, n_classes, l_max, n_rbf, seed=seed)
    elif kind == "graph_minibatch":
        pn, pe = n // workers, e // workers
        csr = random_csr_graph(4 * pn, 4, d_in, n_classes, seed=seed)
        rng = np.random.default_rng(seed + 1)
        subs = [fanout_sample(csr, rng.choice(csr.n_nodes, 8, replace=False),
                              (2, 2), l_max, n_rbf, rng, pad_nodes=pn,
                              pad_edges=pe) for _ in range(workers)]
        g = {k: np.concatenate([s[k] for s in subs]) for k in subs[0]}
    elif kind == "graph_full_large":
        rng = np.random.default_rng(seed)
        nl, el = n // workers, e // workers
        src = rng.integers(0, n, e)
        # no self-loops: a local dst never equals the source's block offset
        dst_l = (src % nl + 1 + rng.integers(0, nl - 1, e)) % nl
        dst = (np.arange(e) // el) * nl + dst_l
        coords = rng.normal(size=(n, 3))
        g = {"node_feat": rng.normal(size=(n, d_in)).astype(np.float32),
             "edge_src": src.astype(np.int32),
             "edge_dst": dst_l.astype(np.int32),
             "edge_mask": np.ones(e, np.float32),
             "node_mask": np.ones(n, np.float32),
             "labels": rng.integers(0, n_classes, n).astype(np.int32)}
        g.update(edge_geometry(coords, src, dst, l_max, n_rbf))
    else:
        raise ValueError(kind)
    return g
