"""DLRM over PS-sharded embeddings (torch counterpart of
``repro/models/recsys/models.py``).

Only DLRM is ported so far; AutoInt, DIEN and xDeepFM follow.  Batches are
dicts of tensors: dense (B, n_dense) f32 | sparse (B, F) int | labels (B,)
{0, 1}.  The port runs tp = 1, so the JAX functions' ``dist`` argument has
no counterpart, and neither do the spec and grad-sync maps.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys.embedding import (
    apply_mlp,
    bce_loss,
    init_mlp,
    init_tables,
    lookup_fields,
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


def dlrm_init(cfg: DLRMConfig, generators=None, *, device=None) -> dict:
    """Random DLRM parameters: ``{"tables", "bot", "top"}``.

    ``generators`` is three ``torch.Generator``s, one each for the tables,
    the bottom MLP and the top MLP (the JAX package splits its key three
    ways); by default three on ``device`` (the card unless given) seeded
    0, 1 and 2.  The numbers differ from ``jax.random``'s, so parity tests
    load the JAX package's parameters through ``repro_torch.interop``."""
    if generators is None:
        dev = resolve_device(device)
        generators = tuple(torch.Generator(device=dev).manual_seed(s)
                           for s in range(3))
    g_tables, g_bot, g_top = generators
    return {
        "tables": init_tables(g_tables, cfg.vocabs, cfg.embed_dim, 1, cfg.dtype),
        "bot": init_mlp(g_bot, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype),
        "top": init_mlp(g_top, (cfg.top_in,) + cfg.top_mlp, cfg.dtype),
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


def _top(dense_params: dict, e: torch.Tensor, dense: torch.Tensor,
         cfg: DLRMConfig) -> torch.Tensor:
    z = apply_mlp(dense_params["bot"], dense.to(cfg.dtype), final_act=torch.relu)
    x = torch.cat([z, _dot_interact(z, e)], dim=1)
    return apply_mlp(dense_params["top"], x)[:, 0]


def dlrm_score(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Serving logits (B,)."""
    e = lookup_fields(params["tables"], batch["sparse"])
    return _top(params, e, batch["dense"], cfg)


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig):
    logit = dlrm_score(params, batch, cfg)
    loss = bce_loss(logit, batch["labels"])
    return loss, {"bce": loss}


def dlrm_lookup(tables: dict, batch: dict) -> torch.Tensor:
    """The embedding stage alone (for the sparse-push training path)."""
    return lookup_fields(tables, batch["sparse"])


def dlrm_loss_from_emb(dense_params: dict, e: torch.Tensor, batch: dict,
                       cfg: DLRMConfig):
    """DLRM loss given the looked-up embeddings ``e`` (B, F, D) — lets the
    trainer take gradients with respect to ``e`` and push them sparsely
    (``core/sparse.SparseTier.push``)."""
    logit = _top(dense_params, e, batch["dense"], cfg)
    loss = bce_loss(logit, batch["labels"])
    return loss, {"bce": loss}
