"""The four recsys architectures over PS-sharded embeddings (torch
counterpart of ``repro/models/recsys/models.py``).

Each model exposes: Config, ``*_init(cfg, generator(s), tp)``, ``*_specs``,
``*_grad_sync``, ``*_loss(params, batch, cfg, dist)``, ``*_score`` (serving
logits) and ``*_user_tower`` (retrieval).  Batches are dicts of tensors:
dense (B, n_dense) f32 | sparse (B, F) int | labels (B,) {0, 1}; DIEN adds
hist_items / hist_cats (B, T).  ``dist`` (a ``models.common.Dist``, last
and optional) carries the model axis: the tables are row-sharded over it
and the dense stage runs on this rank's block of the worker's rows; with
``dist=None`` the tables are whole.  The functions are per-rank code on the
rank's local parameters (``runtime.trainer.local_params``).

Initializers take ``torch.Generator``s and draw other numbers than
``jax.random``, so parity tests load the JAX package's parameters through
``repro_torch.interop``; a ``None`` generator draws a seeded one on
``device`` (the card unless given), and ``device="meta"`` gives the shapes
only (the JAX package's ``jax.eval_shape`` of the init).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import Dist, dense_init, gen_device
from repro_torch.models.recsys.embedding import (
    apply_mlp,
    bce_loss,
    init_mlp,
    init_tables,
    lookup_fields,
    lookup_sequence,
    masked_rows,
    mlp_grad_sync,
    mlp_specs,
    split_batch_model,
    table_grad_sync,
    table_specs,
)

# Criteo-Terabyte vocabulary sizes capped at 40M (MLPerf DLRM convention)
CRITEO_VOCABS = (
    40000000, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 40000000,
    11316796, 40000000, 452104, 12606, 104, 35,
)


# ===========================================================================
# DLRM (MLPerf config)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocabs: tuple = CRITEO_VOCABS
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocabs)

    @property
    def top_in(self) -> int:
        f = self.n_sparse + 1
        return self.embed_dim + f * (f - 1) // 2

    def param_count(self) -> int:
        n = sum(self.vocabs) * self.embed_dim
        dims_b = (self.n_dense,) + self.bot_mlp
        dims_t = (self.top_in,) + self.top_mlp
        for d in (dims_b, dims_t):
            n += sum(d[i] * d[i + 1] + d[i + 1] for i in range(len(d) - 1))
        return n


def _generators(generators, n: int, device) -> tuple:
    """``n`` generators: the caller's (one, used for every group, or a
    sequence of ``n``), ``n`` on ``device`` seeded 0..n-1, or ``None``s for
    ``device="meta"``."""
    if generators is None:
        dev = resolve_device(device)
        if dev.type == "meta":
            return (None,) * n
        return tuple(torch.Generator(device=dev).manual_seed(s)
                     for s in range(n))
    if isinstance(generators, torch.Generator):
        return (generators,) * n
    return tuple(generators)


def dlrm_init(cfg: DLRMConfig, generators=None, tp: int = 1, *,
              device=None) -> dict:
    """Random DLRM parameters: ``{"tables", "bot", "top"}``, each table
    padded to ``padded_vocab(v, tp)`` rows.

    ``generators`` is three ``torch.Generator``s, one each for the tables,
    the bottom MLP and the top MLP (the JAX package splits its key three
    ways), or one used for all three (module docstring for ``None``)."""
    g_tables, g_bot, g_top = _generators(generators, 3, device)
    return {
        "tables": init_tables(g_tables, cfg.vocabs, cfg.embed_dim, tp,
                              cfg.dtype),
        "bot": init_mlp(g_bot, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype),
        "top": init_mlp(g_top, (cfg.top_in,) + cfg.top_mlp, cfg.dtype),
    }


def dlrm_specs(cfg: DLRMConfig, tp: int) -> dict:
    return {
        "tables": table_specs(cfg.vocabs, tp),
        "bot": mlp_specs((cfg.n_dense,) + cfg.bot_mlp),
        "top": mlp_specs((cfg.top_in,) + cfg.top_mlp),
    }


def dlrm_grad_sync(cfg: DLRMConfig, tp: int) -> dict:
    return {
        "tables": table_grad_sync(cfg.vocabs),
        "bot": mlp_grad_sync((cfg.n_dense,) + cfg.bot_mlp, tp),
        "top": mlp_grad_sync((cfg.top_in,) + cfg.top_mlp, tp),
    }


def _dot_interact(z: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise-dot interaction.  z (B, D); e (B, F, D) -> (B, (F+1)F/2),
    the upper triangle of the Gram matrix in row-major order (the order of
    ``jnp.triu_indices(F + 1, k=1)``)."""
    f = e.shape[1]
    cat = torch.cat([z[:, None, :], e], dim=1)  # (B, F+1, D)
    g = torch.bmm(cat, cat.transpose(1, 2))
    iu, ju = torch.triu_indices(f + 1, f + 1, offset=1, device=z.device)
    return g[:, iu, ju]


def _bottom(dense_params: dict, batch: dict, cfg: DLRMConfig,
            dist: Dist | None) -> torch.Tensor:
    dense = split_batch_model(batch["dense"], dist)
    return apply_mlp(dense_params["bot"], dense.to(cfg.dtype),
                     final_act=torch.relu)


def _top(dense_params: dict, e: torch.Tensor, batch: dict, cfg: DLRMConfig,
         dist: Dist | None) -> torch.Tensor:
    z = _bottom(dense_params, batch, cfg, dist)
    x = torch.cat([z, _dot_interact(z, e)], dim=1)
    return apply_mlp(dense_params["top"], x)[:, 0]


def _bce(logit, batch, dist):
    loss = bce_loss(logit, split_batch_model(batch["labels"], dist), dist)
    return loss, {"bce": loss}


def dlrm_score(params: dict, batch: dict, cfg: DLRMConfig,
               dist: Dist | None = None) -> torch.Tensor:
    """Serving logits (B/tp,)."""
    e = lookup_fields(params["tables"], batch["sparse"], dist)
    return _top(params, e, batch, cfg, dist)


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig,
              dist: Dist | None = None):
    return _bce(dlrm_score(params, batch, cfg, dist), batch, dist)


def dlrm_lookup(tables: dict, batch: dict,
                dist: Dist | None = None) -> torch.Tensor:
    """The embedding stage alone (for the sparse-push training path)."""
    return lookup_fields(tables, batch["sparse"], dist)


def dlrm_loss_from_emb(dense_params: dict, e: torch.Tensor, batch: dict,
                       cfg: DLRMConfig, dist: Dist | None = None):
    """DLRM loss given the looked-up embeddings ``e`` (B/tp, F, D) — lets the
    trainer take gradients with respect to ``e`` and push them sparsely
    (``runtime/sparse_push``, ``core/sparse.SparseTier.push``)."""
    return _bce(_top(dense_params, e, batch, cfg, dist), batch, dist)


def dlrm_user_tower(params: dict, batch: dict, cfg: DLRMConfig,
                    dist: Dist | None = None) -> torch.Tensor:
    """Retrieval user vector: bottom-MLP(dense) + mean of user-side embeds."""
    e = lookup_fields(params["tables"], batch["sparse"], dist)
    return _bottom(params, batch, cfg, dist) + torch.mean(e, dim=1)


# ===========================================================================
# AutoInt
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    vocab_per_field: int = 10000
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype: Any = torch.float32

    @property
    def vocabs(self) -> tuple:
        return (self.vocab_per_field,) * self.n_sparse

    def param_count(self) -> int:
        n = sum(self.vocabs) * self.embed_dim
        d_in = self.embed_dim
        for _ in range(self.n_attn_layers):
            n += 3 * d_in * self.d_attn + d_in * self.d_attn
            d_in = self.d_attn
        return n + self.n_sparse * self.d_attn


_ATTN = ("wq", "wk", "wv", "wres")


def autoint_init(cfg: AutoIntConfig, generator=None, tp: int = 1, *,
                 device=None) -> dict:
    """Tables, then each attention layer's wq, wk, wv, wres, then ``out``,
    drawn from one generator in that order."""
    (g,) = _generators(generator, 1, device)
    p = {"tables": init_tables(g, cfg.vocabs, cfg.embed_dim, tp, cfg.dtype)}
    d_in = cfg.embed_dim
    for i in range(cfg.n_attn_layers):
        p[f"attn{i}"] = {k: dense_init(g, (d_in, cfg.d_attn), d_in, cfg.dtype)
                         for k in _ATTN}
        d_in = cfg.d_attn
    n_out = cfg.n_sparse * cfg.d_attn
    p["out"] = dense_init(g, (n_out, 1), n_out, cfg.dtype)
    return p


def autoint_specs(cfg: AutoIntConfig, tp: int) -> dict:
    sp = {"tables": table_specs(cfg.vocabs, tp), "out": ()}
    for i in range(cfg.n_attn_layers):
        sp[f"attn{i}"] = {k: () for k in _ATTN}
    return sp


def autoint_grad_sync(cfg: AutoIntConfig, tp: int) -> dict:
    s = "psum_model" if tp > 1 else "none"
    g = {"tables": table_grad_sync(cfg.vocabs), "out": s}
    for i in range(cfg.n_attn_layers):
        g[f"attn{i}"] = {k: s for k in _ATTN}
    return g


def autoint_score(params: dict, batch: dict, cfg: AutoIntConfig,
                  dist: Dist | None = None) -> torch.Tensor:
    x = lookup_fields(params["tables"], batch["sparse"], dist)  # (B, F, D)
    h = cfg.n_heads
    b, f = x.shape[:2]
    for i in range(cfg.n_attn_layers):
        ap = params[f"attn{i}"]
        q = (x @ ap["wq"]).reshape(b, f, h, -1)
        k = (x @ ap["wk"]).reshape(b, f, h, -1)
        v = (x @ ap["wv"]).reshape(b, f, h, -1)
        # sqrt(d) as an f32 tensor: JAX divides by jnp.sqrt(d * 1.0)
        scale = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32,
                             device=q.device)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / scale
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(b, f, -1)
        x = torch.relu(o + x @ ap["wres"])
    return (x.reshape(b, -1) @ params["out"])[:, 0]


def autoint_loss(params: dict, batch: dict, cfg: AutoIntConfig,
                 dist: Dist | None = None):
    return _bce(autoint_score(params, batch, cfg, dist), batch, dist)


def autoint_user_tower(params: dict, batch: dict, cfg: AutoIntConfig,
                       dist: Dist | None = None) -> torch.Tensor:
    e = lookup_fields(params["tables"], batch["sparse"], dist)
    return torch.mean(e, dim=1)


# ===========================================================================
# DIEN (GRU + AUGRU over the behavior sequence)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 63001
    n_cats: int = 801
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80, 1)
    dtype: Any = torch.float32

    @property
    def vocabs(self) -> tuple:
        return (self.n_items, self.n_cats)

    @property
    def in_dim(self) -> int:
        return 2 * self.embed_dim  # item + category

    @property
    def mlp_in(self) -> int:
        return self.in_dim * 2 + self.gru_dim

    def param_count(self) -> int:
        n = sum(self.vocabs) * self.embed_dim
        n += 2 * 3 * (self.in_dim + self.gru_dim) * self.gru_dim  # GRU + AUGRU
        n += (self.in_dim + self.gru_dim) * 1  # attention
        dims = (self.mlp_in,) + self.mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return n


_GATES = ("r", "z", "h")


def _gru_init(g, d_in: int, d_h: int, dtype) -> dict:
    return {gate: {"w": dense_init(g, (d_in + d_h, d_h), d_in + d_h, dtype),
                   "b": torch.zeros((d_h,), dtype=dtype,
                                    device=gen_device(g))}
            for gate in _GATES}


def _gru_cell(p: dict, h: torch.Tensor, x: torch.Tensor,
              a: torch.Tensor | None = None) -> torch.Tensor:
    xh = torch.cat([x, h], dim=-1)
    r = torch.sigmoid(xh @ p["r"]["w"] + p["r"]["b"])
    z = torch.sigmoid(xh @ p["z"]["w"] + p["z"]["b"])
    if a is not None:  # AUGRU: attention scales the update gate
        z = z * a[:, None]
    xrh = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(xrh @ p["h"]["w"] + p["h"]["b"])
    return (1.0 - z) * h + z * hh


def dien_init(cfg: DIENConfig, generator=None, tp: int = 1, *,
              device=None) -> dict:
    """Tables, the GRU, the AUGRU, the attention vector and the MLP, drawn
    from one generator in that order."""
    (g,) = _generators(generator, 1, device)
    return {
        "tables": init_tables(g, cfg.vocabs, cfg.embed_dim, tp, cfg.dtype),
        "gru": _gru_init(g, cfg.in_dim, cfg.gru_dim, cfg.dtype),
        "augru": _gru_init(g, cfg.gru_dim, cfg.gru_dim, cfg.dtype),
        "att": dense_init(g, (cfg.gru_dim + cfg.in_dim, 1), cfg.gru_dim,
                          cfg.dtype),
        "mlp": init_mlp(g, (cfg.mlp_in,) + cfg.mlp, cfg.dtype),
    }


def dien_specs(cfg: DIENConfig, tp: int) -> dict:
    return {
        "tables": table_specs(cfg.vocabs, tp),
        "gru": {g: {"w": (), "b": ()} for g in _GATES},
        "augru": {g: {"w": (), "b": ()} for g in _GATES},
        "att": (),
        "mlp": mlp_specs((cfg.mlp_in,) + cfg.mlp),
    }


def dien_grad_sync(cfg: DIENConfig, tp: int) -> dict:
    s = "psum_model" if tp > 1 else "none"
    return {
        "tables": table_grad_sync(cfg.vocabs),
        "gru": {g: {"w": s, "b": s} for g in _GATES},
        "augru": {g: {"w": s, "b": s} for g in _GATES},
        "att": s,
        "mlp": mlp_grad_sync((cfg.mlp_in,) + cfg.mlp, tp),
    }


def dien_score(params: dict, batch: dict, cfg: DIENConfig,
               dist: Dist | None = None) -> torch.Tensor:
    """The interest-extraction GRU and the AUGRU run as Python loops over
    the T steps of the history (the JAX package's two ``lax.scan``s)."""
    tables = params["tables"]
    hist = torch.cat([
        lookup_sequence(tables["t0"], batch["hist_items"], dist),
        lookup_sequence(tables["t1"], batch["hist_cats"], dist),
    ], dim=-1)  # (B, T, 2D)
    tgt = lookup_fields(tables, batch["sparse"], dist)  # (B, 2, D)
    tgt = tgt.reshape(tgt.shape[0], -1)  # (B, 2D)
    b, t = hist.shape[:2]

    # interest extraction GRU
    h = torch.zeros((b, cfg.gru_dim), dtype=cfg.dtype, device=hist.device)
    states = []
    for i in range(t):
        h = _gru_cell(params["gru"], h, hist[:, i])
        states.append(h)
    hs = torch.stack(states, dim=1)  # (B, T, G)

    # attention against the target
    att_in = torch.cat([hs, tgt[:, None].expand(b, t, tgt.shape[1])], dim=-1)
    scores = torch.softmax((att_in @ params["att"])[..., 0], dim=1)  # (B, T)

    # interest evolution AUGRU
    h = torch.zeros((b, cfg.gru_dim), dtype=cfg.dtype, device=hist.device)
    for i in range(t):
        h = _gru_cell(params["augru"], h, hs[:, i], scores[:, i])
    feat = torch.cat([tgt, h, torch.mean(hist, dim=1)], dim=-1)
    return apply_mlp(params["mlp"], feat)[:, 0]


def dien_loss(params: dict, batch: dict, cfg: DIENConfig,
              dist: Dist | None = None):
    return _bce(dien_score(params, batch, cfg, dist), batch, dist)


def dien_user_tower(params: dict, batch: dict, cfg: DIENConfig,
                    dist: Dist | None = None) -> torch.Tensor:
    hist = lookup_sequence(params["tables"]["t0"], batch["hist_items"], dist)
    return torch.mean(hist, dim=1)


# ===========================================================================
# xDeepFM (CIN + DNN + linear)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    vocab_per_field: int = 10000
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp: tuple = (400, 400, 1)
    dtype: Any = torch.float32

    @property
    def vocabs(self) -> tuple:
        return (self.vocab_per_field,) * self.n_sparse

    def param_count(self) -> int:
        n = sum(self.vocabs) * (self.embed_dim + 1)  # embeds + linear weights
        h_prev = self.n_sparse
        for h in self.cin_layers:
            n += h * h_prev * self.n_sparse
            h_prev = h
        n += sum(self.cin_layers)  # cin output weights
        dims = (self.n_sparse * self.embed_dim,) + self.mlp
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return n


def xdeepfm_init(cfg: XDeepFMConfig, generator=None, tp: int = 1, *,
                 device=None) -> dict:
    """Tables, linear tables, MLP, ``cin_out``, then each CIN layer, drawn
    from one generator in that order."""
    (g,) = _generators(generator, 1, device)
    n_cin = sum(cfg.cin_layers)
    p = {
        "tables": init_tables(g, cfg.vocabs, cfg.embed_dim, tp, cfg.dtype),
        "linear": init_tables(g, cfg.vocabs, 1, tp, cfg.dtype),
        "mlp": init_mlp(g, (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp,
                        cfg.dtype),
        "cin_out": dense_init(g, (n_cin, 1), n_cin, cfg.dtype),
    }
    h_prev = cfg.n_sparse
    for i, h in enumerate(cfg.cin_layers):
        p[f"cin{i}"] = dense_init(g, (h, h_prev, cfg.n_sparse),
                                  h_prev * cfg.n_sparse, cfg.dtype)
        h_prev = h
    return p


def xdeepfm_specs(cfg: XDeepFMConfig, tp: int) -> dict:
    sp = {
        "tables": table_specs(cfg.vocabs, tp),
        "linear": table_specs(cfg.vocabs, tp),
        "mlp": mlp_specs((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp),
        "cin_out": (),
    }
    for i in range(len(cfg.cin_layers)):
        sp[f"cin{i}"] = ()
    return sp


def xdeepfm_grad_sync(cfg: XDeepFMConfig, tp: int) -> dict:
    s = "psum_model" if tp > 1 else "none"
    g = {
        "tables": table_grad_sync(cfg.vocabs),
        "linear": table_grad_sync(cfg.vocabs),
        "mlp": mlp_grad_sync((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp, tp),
        "cin_out": s,
    }
    for i in range(len(cfg.cin_layers)):
        g[f"cin{i}"] = s
    return g


def xdeepfm_score(params: dict, batch: dict, cfg: XDeepFMConfig,
                  dist: Dist | None = None) -> torch.Tensor:
    x0 = lookup_fields(params["tables"], batch["sparse"], dist)  # (B, F, D)
    lin = lookup_fields(params["linear"], batch["sparse"], dist)  # (B, F, 1)
    xk = x0
    pools = []
    for i in range(len(cfg.cin_layers)):
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)
        xk = torch.einsum("bhfd,ohf->bod", z, params[f"cin{i}"])
        pools.append(torch.sum(xk, dim=-1))  # (B, H)
    cin = torch.cat(pools, dim=-1) @ params["cin_out"]
    dnn = apply_mlp(params["mlp"], x0.reshape(x0.shape[0], -1))
    return (cin + dnn)[:, 0] + torch.sum(lin[..., 0], dim=-1)


def xdeepfm_loss(params: dict, batch: dict, cfg: XDeepFMConfig,
                 dist: Dist | None = None):
    return _bce(xdeepfm_score(params, batch, cfg, dist), batch, dist)


def xdeepfm_user_tower(params: dict, batch: dict, cfg: XDeepFMConfig,
                       dist: Dist | None = None) -> torch.Tensor:
    e = lookup_fields(params["tables"], batch["sparse"], dist)
    return torch.mean(e, dim=1)


# ===========================================================================
# retrieval: bulk candidate scoring (two-tower readout)
# ===========================================================================

def bulk_retrieval(params: dict, batch: dict, user_tower, item_table: str,
                   proj_dim: int, cfg, dist: Dist | None = None
                   ) -> torch.Tensor:
    """Score one user against N candidates.  ``cand_ids`` (N_loc,) arrive
    as this rank's slice (they are sharded over every mesh axis); each
    table shard contributes its rows by the mask + psum PS pull (summed
    over the model axis as the JAX package sums them).

    Returns (N_loc,) scores for this rank's candidate slice."""
    u = user_tower(params, batch, cfg, dist)  # (B_loc, D_u)
    u = torch.mean(u, dim=0)  # single user vector (B = 1 semantics)
    e = masked_rows(params["tables"][item_table], batch["cand_ids"], dist)
    if dist is not None:
        e = dist.psum_model(e)  # (N_loc, D)
    d = min(u.shape[0], e.shape[1])
    return e[:, :d] @ u[:d]
