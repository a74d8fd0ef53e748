"""Decoder-only transformer with manual tensor parallelism (torch
counterpart of ``repro/models/transformer.py``): the training and serving
paths, per rank.

Covers GQA (kv heads replicated when ``n_kv_heads < tp``), optional QKV
biases, gemma3's sliding-window/global layer interleaving and its
``sqrt(d)`` embedding scale, SiLU or (tanh-approximated) GELU gates, and
MoE FFNs (granite, qwen2-moe; ``models/moe.py``) whose load-balance aux
losses are summed over the layers into the loss.  Parameters are a nested
``dict[str, Tensor]`` with the JAX package's keys and shapes, stacked over
layers (``params["layers"]["wq"]`` is ``(L, d, H*hd)`` globally), so the
two packages' trees flatten to the same chunk space; the MoE router is an
f32 leaf even in a bf16 model, as in JAX.

Tensor-parallel layout over the ``model`` axis (size ``tp``), as JAX's:
q/o heads sharded ``tp_attn = min(tp, n_heads)`` ways and duplicated
``R = tp / tp_attn`` times in the stored layout (the block output is
summed over the model axis and divided by R; ``grad_sync`` rescales the
duplicates' gradients by R); k/v sharded when ``n_kv_heads >= tp``, else
replicated (their gradients summed over the model axis); the FFN hidden
dim sharded, each expert's too, the router replicated; embeddings and head vocab-sharded, the loss a distributed
softmax cross-entropy; the decode cache sequence-sharded with every kv
head resident, decode attention a log-sum-exp combine across shards.

Sequence parallelism (``seq_parallel``), as JAX's: the embedding's
combine over the model axis is a ``psum_scatter`` over the sequence, so
each rank carries its S/tp block of the hidden states between the blocks
(and through each layer's ``checkpoint``, the memory it saves); each block
takes its RMS norm on that block, all-gathers the sequence, and ends in a
``psum_scatter`` over the sequence in place of the ``psum``; the loss
re-gathers the sequence before the vocab-sharded head.  Positions stay
the whole sequence.  Prefill and decode ignore it, as JAX's do.

Every function takes the rank's local pieces and a ``Dist`` whose
collectives are differentiable with JAX's transposes
(``models/common.py``); ``tp`` is ``dist.tp`` (JAX's functions take it
beside ``dist``), and ``dist=None`` is ``Dist.none()``, one device.

All matrix products are ``torch.matmul``: the JAX package leaves them to
XLA, outside any Pallas kernel.  Attention is scanned over blocks of
``attn_chunk`` queries (the whole sequence is one block when the chunk
does not divide it), each block with the JAX math: f32 scores times
``1/sqrt(hd)``, mask value -1e30, softmax in f32, a cast to the compute
dtype before the PV product, and on local layers the window rule
``k > q - window``; only one block's (cq, Sk) scores are alive at a time.
``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the layer body),
so a step keeps one layer's activations instead of all of them.

Serving (``prefill``, ``decode_step``; ``init_cache_unrolled`` /
``decode_step_unrolled`` with rolling window caches on local layers) is
the JAX package's.  Each cast follows the JAX code: the head's product in
the compute dtype cast to f32 for the greedy argmax (the first maximal id
wins ties, the lowest id across shards), f32 scores, and the softmax
numerator cast to the compute dtype before the value product.  A decode
step writes the new position into the cache it is given and returns that
cache (the JAX function returns a new one); decode attention is plain
math, as in the JAX package, which has no Pallas kernel for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch._dynamo  # noqa: F401  (see below)
from torch.utils.checkpoint import checkpoint

# ``checkpoint`` is wrapped by ``torch._disable_dynamo``, which imports
# ``torch._dynamo`` at its first call.  That import leaves frames chained
# to the caller's stack alive until a cyclic collection, so the first
# ``lm_loss_and_grad`` of a process kept its weight copy (2.6 GB at
# gemma3-1b's width) past its last reference.  Imported here, it runs
# with no weights on the stack.

from repro_torch.device import resolve_device
from repro_torch.models.common import (
    Dist,
    act_fn,
    apply_rope,
    dense_init,
    embed_init,
    rms_norm,
)
from repro_torch.models.moe import MoEConfig, moe_ffn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: int | None = None  # window for local layers
    global_every: int = 0  # 0 = all layers global; k = layers k-1, 2k-1,... global
    moe: MoEConfig | None = None
    act: str = "silu"  # "silu", else GELU (tanh approximation)
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 1024  # q-block size for chunked attention
    eps: float = 1e-6
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    seq_parallel: bool = False  # sequence-sharded activations (tp > 1)

    # ---- TP derived quantities -------------------------------------
    def tp_attn(self, tp: int) -> int:
        return min(tp, self.n_heads)

    def attn_replicas(self, tp: int) -> int:
        return tp // self.tp_attn(tp)

    def heads_local(self, tp: int) -> int:
        return self.n_heads // self.tp_attn(tp)

    def kv_sharded(self, tp: int) -> bool:
        return self.n_kv_heads >= tp

    def kv_heads_local(self, tp: int) -> int:
        return self.n_kv_heads // tp if self.kv_sharded(tp) else self.n_kv_heads

    def vocab_padded(self, tp: int = 1) -> int:
        return -(-self.vocab // (tp * 128)) * (tp * 128)

    def is_global_layer(self, layer: int) -> bool:
        if self.global_every <= 0 or self.sliding_window is None:
            return True
        return (layer + 1) % self.global_every == 0

    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Exact parameter count (excluding vocab padding)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            attn += self.n_heads * hd + 2 * self.n_kv_heads * hd
        if self.moe is not None:
            m = self.moe
            ffn = d * m.n_experts + 3 * d * m.d_ff_expert * m.n_experts
            if m.shared_d_ff:
                ffn += 3 * d * m.shared_d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Per-token active params (MoE: the router, the top_k experts and
        the shared expert)."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        full_ffn = d * m.n_experts + 3 * d * m.d_ff_expert * m.n_experts
        act_ffn = d * m.n_experts + 3 * d * (m.d_ff_expert * m.top_k
                                             + m.shared_d_ff)
        return self.param_count() - self.n_layers * (full_ffn - act_ffn)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None, tp: int = 1) -> dict:
    """Random global parameters drawn from ``generator`` (a fresh one
    seeded 0 on ``device`` when None), laid out as the JAX package's tree
    for ``tp``: the duplicated q/o layout materialized, the vocab tables
    drawn at ``vocab_padded(1)`` rows and zero-padded to
    ``vocab_padded(tp)``, so every ``tp`` draws the same model."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    elif device is not None and torch.device(device).type != generator.device.type:
        raise ValueError(
            f"generator lives on {generator.device}, device is {device}")
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    R = cfg.attn_replicas(tp)
    pdt = cfg.param_dtype
    dev = generator.device
    qdim = cfg.n_heads * hd
    kvdim = cfg.n_kv_heads * hd

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=dev)

    def tile_r(x):  # duplicate the head layout R times on the last dim
        return x.repeat(*(1,) * (x.dim() - 1), R) if R > 1 else x

    layers: dict[str, Any] = {
        "ln1": zeros(L, d),
        "ln2": zeros(L, d),
        "wq": tile_r(dense_init(generator, (L, d, qdim), d, pdt)),
        "wk": dense_init(generator, (L, d, kvdim), d, pdt),
        "wv": dense_init(generator, (L, d, kvdim), d, pdt),
        "wo": tile_r(dense_init(generator, (L, d, qdim), qdim, pdt))
        .transpose(1, 2).contiguous(),
    }
    if cfg.qkv_bias:
        layers["bq"] = tile_r(zeros(L, qdim))
        layers["bk"] = zeros(L, kvdim)
        layers["bv"] = zeros(L, kvdim)
    if cfg.moe is None:
        layers["w1"] = dense_init(generator, (L, d, cfg.d_ff), d, pdt)
        layers["w3"] = dense_init(generator, (L, d, cfg.d_ff), d, pdt)
        layers["w2"] = dense_init(generator, (L, cfg.d_ff, d), cfg.d_ff, pdt)
    else:
        m = cfg.moe
        E, fe, fs = m.n_experts, m.d_ff_expert, m.shared_d_ff
        layers["router"] = dense_init(generator, (L, d, E), d, torch.float32)
        layers["we1"] = dense_init(generator, (L, E, d, fe), d, pdt)
        layers["we3"] = dense_init(generator, (L, E, d, fe), d, pdt)
        layers["we2"] = dense_init(generator, (L, E, fe, d), fe, pdt)
        if fs:
            layers["ws1"] = dense_init(generator, (L, d, fs), d, pdt)
            layers["ws3"] = dense_init(generator, (L, d, fs), d, pdt)
            layers["ws2"] = dense_init(generator, (L, fs, d), fs, pdt)
    vp1, vp = cfg.vocab_padded(1), cfg.vocab_padded(tp)

    def vocab_init():
        w = embed_init(generator, (vp1, d), pdt)
        if vp > vp1:  # dead rows: tokens never index them, the loss masks them
            w = torch.cat([w, zeros(vp - vp1, d)])
        return w

    return {
        "embed": vocab_init(),
        "layers": layers,
        "ln_f": zeros(d),
        "head": vocab_init(),
    }


def abstract_params(cfg: TransformerConfig, tp: int = 1) -> dict:
    """``init_params``'s global tree for ``tp`` as meta tensors: shapes and
    dtypes only, no storage (the JAX package's ``jax.eval_shape`` of
    ``init_params``)."""
    L, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    R = cfg.attn_replicas(tp)
    qdim, kvdim, vp = R * cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.vocab_padded(tp)

    def meta(*shape, dtype=cfg.param_dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    layers = {"ln1": meta(L, d), "ln2": meta(L, d), "wq": meta(L, d, qdim),
              "wk": meta(L, d, kvdim), "wv": meta(L, d, kvdim),
              "wo": meta(L, qdim, d)}
    if cfg.qkv_bias:
        layers.update(bq=meta(L, qdim), bk=meta(L, kvdim), bv=meta(L, kvdim))
    if cfg.moe is None:
        layers.update(w1=meta(L, d, ff), w3=meta(L, d, ff), w2=meta(L, ff, d))
    else:
        E, fe, fs = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.moe.shared_d_ff
        layers.update(router=meta(L, d, E, dtype=torch.float32),
                      we1=meta(L, E, d, fe), we3=meta(L, E, d, fe),
                      we2=meta(L, E, fe, d))
        if fs:
            layers.update(ws1=meta(L, d, fs), ws3=meta(L, d, fs),
                          ws2=meta(L, fs, d))
    return {"embed": meta(vp, d), "layers": layers, "ln_f": meta(d),
            "head": meta(vp, d)}


def make_param_specs(cfg: TransformerConfig, tp: int) -> dict:
    """Each parameter's sharding as JAX's ``PartitionSpec`` names it: a
    tuple of an axis name or None per sharded dimension, ``()`` for
    replicated."""
    M = "model" if tp > 1 else None
    kvs = cfg.kv_sharded(tp)
    kv = (None, None, M) if kvs else ()
    kvb = (None, M) if kvs else ()
    layers: dict[str, Any] = {
        "ln1": (), "ln2": (),
        "wq": (None, None, M), "wk": kv, "wv": kv, "wo": (None, M, None),
    }
    if cfg.qkv_bias:
        layers.update(bq=(None, M), bk=kvb, bv=kvb)
    if cfg.moe is None:
        layers.update(w1=(None, None, M), w3=(None, None, M),
                      w2=(None, M, None))
    else:
        layers.update(router=(), we1=(None, None, None, M),
                      we3=(None, None, None, M), we2=(None, None, M, None))
        if cfg.moe.shared_d_ff:
            layers.update(ws1=(None, None, M), ws3=(None, None, M),
                          ws2=(None, M, None))
    return {"embed": (M, None), "layers": layers, "ln_f": (), "head": (M, None)}


def grad_sync(cfg: TransformerConfig, tp: int) -> dict:
    """Per-tensor gradient correction before the PS exchange (the JAX
    function's tags): ``psum_model`` for replicated copies whose per-rank
    gradient covers only the local heads or vocab rows (kv when
    replicated, the norms, the router), ``scale_R`` for the duplicated q/o
    layout."""
    R = cfg.attn_replicas(tp)
    rep = "psum_model" if tp > 1 else "none"
    qsync = f"scale_{R}" if R > 1 else "none"
    kvsync = "none" if cfg.kv_sharded(tp) else rep
    layers: dict[str, Any] = {"ln1": rep, "ln2": rep, "wq": qsync,
                              "wk": kvsync, "wv": kvsync, "wo": qsync}
    if cfg.qkv_bias:
        layers.update(bq=qsync, bk=kvsync, bv=kvsync)
    if cfg.moe is None:
        layers.update(w1="none", w3="none", w2="none")
    else:
        layers.update(router=rep, we1="none", we3="none", we2="none")
        if cfg.moe.shared_d_ff:
            layers.update(ws1="none", ws3="none", ws2="none")
    return {"embed": "none", "layers": layers, "ln_f": rep, "head": "none"}


# ---------------------------------------------------------------------------
# building blocks (per-rank code)
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg: TransformerConfig, dist: Dist,
           scatter_seq: bool = False):
    """Vocab-sharded lookup: local take, mask, psum (the PS 'pull').
    ``scatter_seq``: the combine also shards the sequence, in one
    collective (the sequence-parallel entry)."""
    table = params["embed"]
    if dist.tp > 1:
        vloc = table.shape[0]
        local = tokens.long() - dist.model_index() * vloc
        ok = (local >= 0) & (local < vloc)
        emb = table[local.clamp(0, vloc - 1)]
        emb = torch.where(ok[..., None], emb, 0).to(cfg.dtype)
        emb = (dist.psum_scatter_model(emb, axis=1) if scatter_seq
               else dist.psum_model(emb))
    else:
        emb = table[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the JAX package does
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()
        emb = emb * scale
    return emb


def _qkv(x, lp, cfg: TransformerConfig, positions):
    """Returns q (B,S,Hloc,hd) and k/v (B,S,Hkv_res,hd), q and k rope'd."""
    hd = cfg.head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_heads(cfg: TransformerConfig, dist: Dist, device):
    """The global ids of this rank's q heads."""
    hloc = cfg.heads_local(dist.tp)
    first = (dist.model_index() % cfg.tp_attn(dist.tp)) * hloc
    return first + torch.arange(hloc, device=device)


def _kv_for_local_q(k, v, cfg: TransformerConfig, dist: Dist):
    """Select, per local q head, its kv head (resident or replicated)."""
    kv_global = _local_heads(cfg, dist, k.device) // cfg.q_group
    if cfg.kv_sharded(dist.tp):
        kv_local = kv_global - dist.model_index() * cfg.kv_heads_local(dist.tp)
    else:
        kv_local = kv_global
    return k.index_select(2, kv_local), v.index_select(2, kv_local)


def _chunked_attention(q, k, v, cfg: TransformerConfig, is_global: bool,
                       q0: int = 0):
    """Causal (optionally windowed) attention over blocks of
    ``attn_chunk`` queries.  q: (B, Sq, H, hd); k/v: (B, Sk, H, hd), one
    kv head per q head; ``q0`` is the absolute position of q[0]."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq = min(cfg.attn_chunk, sq)
    if sq % cq:
        cq = sq
    kpos = torch.arange(sk, device=q.device)
    win = cfg.sliding_window or sk
    outs = []
    for i in range(sq // cq):
        qpos = q0 + i * cq + torch.arange(cq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]  # (q, k) causal
        if not is_global:
            mask = mask & (kpos[None, :] > qpos[:, None] - win)
        qc = q[:, i * cq:(i + 1) * cq]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, k).float() * scale
        scores = torch.where(mask[None, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(q.dtype)
        del scores
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
        del p
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _combine(out, cfg: TransformerConfig, dist: Dist, combine=None):
    """An attention block's partial outputs combined over the model axis
    (``combine``, the psum by default), then / R for the duplicated head
    layout."""
    out = (combine or dist.psum_model)(out)
    R = cfg.attn_replicas(dist.tp)
    return out / R if R > 1 else out


def _attn_block(x, lp, cfg: TransformerConfig, dist: Dist,
                is_global: bool, positions, combine=None):
    """The attention output and the layer's k / v (B, S, Hkv_res, hd),
    which prefill keeps as its cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, lp, cfg, positions)
    ku, vu = _kv_for_local_q(k, v, cfg, dist)
    out = _chunked_attention(q, ku, vu, cfg, is_global)
    del ku, vu
    out = _combine(out.reshape(b, s, -1) @ lp["wo"], cfg, dist, combine)
    return out.to(x.dtype), k, v


_MOE_KEYS = ("router", "we1", "we3", "we2", "ws1", "ws3", "ws2")


def _ffn_block(x, lp, cfg: TransformerConfig, dist: Dist, combine=None):
    """Dense or MoE FFN of (B, S, d); returns (out, the f32 aux loss).
    ``combine`` joins the partial outputs over the model axis (the psum by
    default)."""
    b, s, d = x.shape
    combine = combine or dist.psum_model
    if cfg.moe is None:
        a = act_fn("silu" if cfg.act == "silu" else "gelu")
        h = a(x @ lp["w1"]) * (x @ lp["w3"])
        return (combine(h @ lp["w2"]).to(x.dtype),
                torch.zeros((), dtype=torch.float32, device=x.device))
    weights = {k: lp[k] for k in _MOE_KEYS if k in lp}
    out, aux = moe_ffn(x.reshape(b * s, d), weights, cfg.moe, dist, cfg.act)
    # routing is replicated (under sequence parallelism the FFN sees the
    # gathered sequence), so every model shard has the same aux loss
    return combine(out.reshape(b, s, d)).to(x.dtype), aux


def _layer(x, lp, is_global: bool, cfg: TransformerConfig, dist: Dist,
           positions, sp: bool = False):
    """One decoder layer: the new hidden states, the layer's k / v and its
    aux loss.  ``sp``: ``x`` is this rank's block of the sequence; each
    block norms it, gathers the sequence, and combines its partial
    outputs by a psum-scatter over the sequence (one collective)."""

    def block_in(h):
        return dist.all_gather_model(h, axis=1) if sp else h

    def block_out(y):
        return dist.psum_scatter_model(y, axis=1)

    combine = block_out if sp else None
    h = block_in(rms_norm(x, lp["ln1"], cfg.eps))
    out, k, v = _attn_block(h, lp, cfg, dist, is_global, positions, combine)
    x = x + out
    h = block_in(rms_norm(x, lp["ln2"], cfg.eps))
    f, aux = _ffn_block(h, lp, cfg, dist, combine)
    return x + f, k, v, aux


def _layer_hidden(x, names, is_global, cfg, dist, positions, sp, *weights):
    """``_layer``'s hidden states and aux loss, with the layer's weights
    as arguments (what ``checkpoint`` recomputes)."""
    x, _, _, aux = _layer(x, dict(zip(names, weights)), is_global, cfg, dist,
                          positions, sp)
    return x, aux


def _per_layer(params) -> dict:
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once, where indexing w[li] per layer would scatter each
    # layer's gradient into a zeroed (L, ...) buffer and sum L of them
    return {name: w.unbind(0) for name, w in params["layers"].items()}


def _seq_parallel(cfg: TransformerConfig, dist: Dist) -> bool:
    return cfg.seq_parallel and dist.model_axis is not None


def forward(params, tokens, cfg: TransformerConfig, dist: Dist | None = None):
    """tokens (B, S) -> hidden (B, S, d), or (B, S/tp, d) under sequence
    parallelism, and the aux loss summed over the layers (0 for a dense
    FFN).  With ``remat`` (and autograd on) each layer is recomputed in
    the backward: only its input is kept."""
    dist = Dist.none() if dist is None else dist
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    sp = _seq_parallel(cfg, dist)
    x = _embed(params, tokens, cfg, dist, scatter_seq=sp)
    per_layer = _per_layer(params)
    names = tuple(per_layer)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_layers):
        ws = [per_layer[n][li] for n in names]
        args = (x, names, cfg.is_global_layer(li), cfg, dist, positions, sp,
                *ws)
        if remat:
            x, a = checkpoint(_layer_hidden, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _layer_hidden(*args)
        aux = aux + a
    return x, aux


def lm_loss(params, tokens, labels, cfg: TransformerConfig,
            dist: Dist | None = None):
    """Distributed softmax cross-entropy over the vocab-sharded head.
    Returns the scalar per-worker mean loss and {"ce", "aux"}."""
    dist = Dist.none() if dist is None else dist
    x, aux = forward(params, tokens, cfg, dist)
    x = rms_norm(x, params["ln_f"], cfg.eps)
    if _seq_parallel(cfg, dist):
        # the whole sequence again for the vocab-sharded head
        x = dist.all_gather_model(x, axis=1)
    head = params["head"]  # (Vloc, d)
    vloc = head.shape[0]
    midx = dist.model_index()
    logits = (x @ head.T).float()  # (B, S, Vloc), in the compute dtype first
    if (midx + 1) * vloc > cfg.vocab:  # mask vocab-padding rows out
        gid = midx * vloc + torch.arange(vloc, device=logits.device)
        logits = torch.where(gid < cfg.vocab, logits, -1e30)
    local = labels.long() - midx * vloc
    ok = (local >= 0) & (local < vloc)
    lab = local.clamp(0, vloc - 1)
    lab_logit = torch.gather(logits, -1, lab[..., None])[..., 0]
    lab_logit = dist.psum_model(torch.where(ok, lab_logit, 0.0))
    # the stability max is gradient-free (d lse/d logits is the softmax):
    # detached before the pmax, which has no gradient
    mx = dist.pmax_model(torch.amax(logits.detach(), dim=-1))
    lse = mx + torch.log(dist.psum_model(
        torch.sum(torch.exp(logits - mx[..., None]), dim=-1)))
    ce = torch.mean(lse - lab_logit)
    return ce + aux, {"ce": ce, "aux": aux}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def lm_loss_and_grad(params, tokens, labels, cfg: TransformerConfig,
                     dist: Dist | None = None):
    """(loss, grads): the loss of ``lm_loss`` and its gradient as a tree
    shaped like ``params`` (the port's ``jax.value_and_grad`` of it).

    Module-level tree helpers, not recursive closures: a closure that
    refers to itself is a reference cycle, and one holding the tracked
    leaves kept a worker's whole weight copy alive until the cyclic
    garbage collector happened to run."""
    tracked = _map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm_loss(tracked, tokens, labels, cfg, dist)
    grads = iter(torch.autograd.grad(loss, _tree_leaves(tracked)))
    return loss.detach(), _map_tree(lambda _: next(grads), params)


# ---------------------------------------------------------------------------
# serving: prefill + decode with a sequence-sharded KV cache
# ---------------------------------------------------------------------------

def _seq_local(max_seq: int, tp: int) -> int:
    if max_seq % tp:
        raise ValueError(f"max_seq={max_seq} does not split over tp={tp}")
    return max_seq // tp


def init_cache(cfg: TransformerConfig, batch_local: int, max_seq: int,
               tp: int = 1, device: torch.device | str | None = None) -> dict:
    """A rank's decode cache: (L, B, max_seq/tp, Hkv, hd) zeros in the
    compute dtype, its shard of the sequence, on ``device`` (the card
    unless the caller passes another)."""
    shape = (cfg.n_layers, batch_local, _seq_local(max_seq, tp),
             cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _full_kv(k, v, cfg: TransformerConfig, dist: Dist):
    """Make all kv heads resident (gather over model if weights sharded)."""
    if cfg.kv_sharded(dist.tp) and dist.tp > 1:
        k = dist.all_gather_model(k, axis=2)
        v = dist.all_gather_model(v, axis=2)
    return k, v


def _prefill_hidden(params, tokens, cfg: TransformerConfig, max_seq: int,
                    dist: Dist):
    """The final hidden states (B, S, d) and this rank's cache of
    ``tokens``: its shard of the sequence, zero-padded to ``max_seq``
    (``seq_parallel`` is ignored, as JAX's prefill ignores it)."""
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"{s} prompt tokens exceed max_seq={max_seq}")
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg, dist)
    cache = init_cache(cfg, b, max_seq, dist.tp, device=x.device)
    sloc = cache["k"].shape[2]
    lo = dist.model_index() * sloc
    n = max(0, min(s - lo, sloc))
    per_layer = _per_layer(params)
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        x, k, v, _ = _layer(x, lp, cfg.is_global_layer(li), cfg, dist,
                            positions)
        k, v = _full_kv(k, v, cfg, dist)
        cache["k"][li, :, :n] = k[:, lo:lo + n]
        cache["v"][li, :, :n] = v[:, lo:lo + n]
        del k, v
    return x, cache


def prefill(params, tokens, cfg: TransformerConfig, max_seq: int, *,
            dist: Dist | None = None):
    """Returns (greedy next-token ids (B,) int32, this rank's cache of the
    S prompt tokens, zero-padded to ``max_seq``)."""
    dist = Dist.none() if dist is None else dist
    x, cache = _prefill_hidden(params, tokens, cfg, max_seq, dist)
    return _greedy_logits(params, x[:, -1], cfg, dist), cache


def head_logits(params, xlast, cfg: TransformerConfig,
                dist: Dist | None = None) -> torch.Tensor:
    """f32 logits (B, Vloc) of final hidden states ``xlast`` (B, d) over
    this rank's vocab rows: the head's product in the compute dtype, cast
    to f32, with the vocab padding masked to -1e30 (what
    ``_greedy_logits`` takes the argmax of)."""
    x = rms_norm(xlast, params["ln_f"], cfg.eps)
    head = params["head"]
    vloc = head.shape[0]
    logits = (x @ head.T).float()
    midx = dist.model_index() if dist is not None else 0
    gid = midx * vloc + torch.arange(vloc, device=logits.device)
    return torch.where(gid < cfg.vocab, logits, -1e30)


def _greedy_logits(params, xlast, cfg: TransformerConfig,
                   dist: Dist | None = None) -> torch.Tensor:
    """Greedy next token (B,) int32 over the vocab-sharded head: the first
    maximal id of the shard holding the maximum (the lowest one on a tie
    across shards)."""
    dist = Dist.none() if dist is None else dist
    logits = head_logits(params, xlast, cfg, dist)
    vloc = logits.shape[-1]
    loc_arg = (torch.argmax(logits, dim=-1)
               + dist.model_index() * vloc).to(torch.int32)
    if dist.tp == 1:
        return loc_arg
    loc_max = torch.amax(logits, dim=-1)
    glob_max = dist.pmax_model(loc_max)
    cand = torch.where(loc_max >= glob_max, loc_arg,
                       torch.iinfo(torch.int32).max)
    return -dist.pmax_model(-cand)  # pmin: the lowest winning id


def _decode_attn_distributed(q, k_loc, v_loc, pos: int, cfg: TransformerConfig,
                             dist: Dist, is_global: bool = True):
    """One query position against the sequence-sharded cache.  q: (B,
    Hloc, hd), the local q heads; k_loc / v_loc: (B, Sloc, Hkv, hd), this
    rank's shard of the sequence with every kv head.

    Every shard serves every q head: q is gathered over the model axis,
    each shard computes the partial numerator, denominator and max of all
    heads against its positions, and the partials are rescaled to the
    global max and summed; the local heads' slice is returned.  Local
    layers mask the window (the cache keeps every position for shape
    uniformity)."""
    hd = q.shape[-1]
    sloc = k_loc.shape[1]
    hq = cfg.n_heads
    scale = 1.0 / math.sqrt(hd)
    # the gathered layout is [replica 0 heads, replica 1 heads, ...]
    q_all = dist.all_gather_model(q, axis=1)[:, :hq] if dist.tp > 1 else q
    kv_idx = torch.arange(hq, device=q.device) // cfg.q_group
    k_used = k_loc.index_select(2, kv_idx)  # (B, Sloc, Hq, hd)
    v_used = v_loc.index_select(2, kv_idx)
    gpos = dist.model_index() * sloc + torch.arange(sloc, device=q.device)
    valid = gpos <= pos
    if cfg.sliding_window is not None and not is_global:
        valid = valid & (gpos > pos - cfg.sliding_window)
    scores = torch.einsum("bhd,bshd->bhs", q_all, k_used).float() * scale
    del k_used
    scores = torch.where(valid[None, None, :], scores, -1e30)
    m_loc = torch.amax(scores, dim=-1)  # (B, Hq)
    e = torch.exp(scores - m_loc[..., None])
    den_loc = torch.sum(e, dim=-1)
    num_loc = torch.einsum("bhs,bshd->bhd", e.to(q.dtype), v_used).float()
    if dist.tp == 1:
        return (num_loc / den_loc[..., None]).to(q.dtype)
    m_glob = dist.pmax_model(m_loc)
    r = torch.exp(m_loc - m_glob)
    num = dist.psum_model(num_loc * r[..., None])
    den = dist.psum_model(den_loc * r)
    out_all = num / den[..., None]  # (B, Hq, hd), every shard combined
    return out_all.index_select(1, _local_heads(cfg, dist, q.device)).to(
        q.dtype)


def _decode_layer_out(x, lp, cfg: TransformerConfig, dist: Dist,
                      attn) -> torch.Tensor:
    """One decoder layer for one position: ``attn(h)`` is the attention
    output (B, Hloc, hd) of the normed input ``h`` (B, d)."""
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.eps)
    out = _combine(attn(h).reshape(b, -1) @ lp["wo"], cfg, dist)
    x = x + out.to(x.dtype)
    h = rms_norm(x, lp["ln2"], cfg.eps)
    return x + _ffn_block(h[:, None], lp, cfg, dist)[0][:, 0]


def _decode_qkv(h, lp, cfg: TransformerConfig, dist: Dist, pos: int):
    """q (B, Hloc, hd) and the full k / v (B, Hkv, hd) of one position."""
    b = h.shape[0]
    positions = torch.full((b, 1), pos, device=h.device)
    q, k, v = _qkv(h[:, None], lp, cfg, positions)
    k, v = _full_kv(k, v, cfg, dist)
    return q[:, 0], k[:, 0], v[:, 0]


def decode_hidden(params, token, cache, pos, cfg: TransformerConfig,
                  dist: Dist | None = None):
    """The final hidden state (B, d) of one decode step; the rank owning
    position ``pos`` writes it into every layer's cache, in place
    (``seq_parallel`` is ignored, as in JAX)."""
    dist = Dist.none() if dist is None else dist
    pos = int(pos)
    x = _embed(params, token[:, None], cfg, dist)[:, 0]  # (B, d)
    sloc = cache["k"].shape[2]
    mine = pos // sloc == dist.model_index()
    lpos = pos % sloc
    per_layer = _per_layer(params)
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        kc, vc = cache["k"][li], cache["v"][li]

        def attn(h, lp=lp, kc=kc, vc=vc, li=li):
            q, k, v = _decode_qkv(h, lp, cfg, dist, pos)
            if mine:
                kc[:, lpos] = k
                vc[:, lpos] = v
            return _decode_attn_distributed(q, kc, vc, pos, cfg, dist,
                                            cfg.is_global_layer(li))

        x = _decode_layer_out(x, lp, cfg, dist, attn)
    return x


def decode_step(params, token, cache, pos, cfg: TransformerConfig,
                dist: Dist | None = None):
    """One greedy decode step.  token (B,) int; ``pos``: the count of
    tokens already in the cache.  Returns (next token (B,) int32, the
    cache, updated in place at ``pos``)."""
    dist = Dist.none() if dist is None else dist
    x = decode_hidden(params, token, cache, pos, cfg, dist)
    return _greedy_logits(params, x, cfg, dist), cache


# ---------------------------------------------------------------------------
# unrolled decode with per-layer cache sizes (sliding-window archs, long ctx)
# ---------------------------------------------------------------------------

def init_cache_unrolled(cfg: TransformerConfig, batch_local: int,
                        max_seq: int, tp: int = 1,
                        device: torch.device | str | None = None) -> list:
    """Per-layer caches: a rolling window for local layers (replicated over
    the model axis: tiny), this rank's sequence shard for global ones,
    zeros in the compute dtype on ``device``."""
    dev = resolve_device(device)
    sloc = _seq_local(max_seq, tp)
    caches = []
    for li in range(cfg.n_layers):
        s = sloc if cfg.is_global_layer(li) else cfg.sliding_window
        shape = (batch_local, s, cfg.n_kv_heads, cfg.head_dim)
        caches.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)})
    return caches


def _window_decode_attn(q, k_roll, v_roll, pos: int, cfg: TransformerConfig,
                        dist: Dist):
    """The local q heads over a rolling window cache (replicated; no
    collectives): slot ``p % w`` holds position ``p``."""
    hd = q.shape[-1]
    w = k_roll.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kv_idx = _local_heads(cfg, dist, q.device) // cfg.q_group
    k_used = k_roll.index_select(2, kv_idx)
    v_used = v_roll.index_select(2, kv_idx)
    slot_age = torch.remainder(pos % w - torch.arange(w, device=q.device), w)
    valid = slot_age <= min(pos, w - 1)
    scores = torch.einsum("bhd,bshd->bhs", q, k_used).float() * scale
    scores = torch.where(valid[None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", p, v_used)


def decode_hidden_unrolled(params, token, caches, pos, cfg: TransformerConfig,
                           dist: Dist | None = None):
    """``decode_hidden`` over ``init_cache_unrolled``'s per-layer caches:
    global layers write position ``pos`` on the rank owning it, local
    layers slot ``pos % window`` on every rank, in place."""
    dist = Dist.none() if dist is None else dist
    pos = int(pos)
    x = _embed(params, token[:, None], cfg, dist)[:, 0]
    per_layer = _per_layer(params)
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        kc, vc = caches[li]["k"], caches[li]["v"]
        glob = cfg.is_global_layer(li)

        def attn(h, lp=lp, kc=kc, vc=vc, glob=glob):
            q, k, v = _decode_qkv(h, lp, cfg, dist, pos)
            if glob:
                sloc = kc.shape[1]
                if pos // sloc == dist.model_index():
                    kc[:, pos % sloc] = k
                    vc[:, pos % sloc] = v
                return _decode_attn_distributed(q, kc, vc, pos, cfg, dist)
            kc[:, pos % kc.shape[1]] = k
            vc[:, pos % vc.shape[1]] = v
            return _window_decode_attn(q, kc, vc, pos, cfg, dist)

        x = _decode_layer_out(x, lp, cfg, dist, attn)
    return x


def decode_step_unrolled(params, token, caches, pos, cfg: TransformerConfig,
                         dist: Dist | None = None):
    """Decode with heterogeneous per-layer caches (gemma3 long context).
    Returns (next token (B,) int32, the caches, updated in place)."""
    dist = Dist.none() if dist is None else dist
    x = decode_hidden_unrolled(params, token, caches, pos, cfg, dist)
    return _greedy_logits(params, x, cfg, dist), caches
