"""Decoder-only transformer (torch counterpart of
``repro/models/transformer.py``): the dense, single-device (tp=1),
non-sequence-parallel training and serving paths.

Covers GQA, gemma3's sliding-window/global layer interleaving and its
``sqrt(d)`` embedding scale.  Parameters are a nested
``dict[str, Tensor]`` with the JAX package's keys and shapes, stacked over
layers (``params["layers"]["wq"]`` is ``(L, d, H*hd)``), so the two
packages' trees flatten to the same chunk space.  QKV biases, activations
other than SiLU, MoE FFNs and sequence parallelism are not ported yet.

All matrix products are ``torch.matmul``: the JAX package leaves them to
XLA, outside any Pallas kernel.  Attention runs unchunked (the JAX q-chunks
only bound memory) with the same math: f32 scores times ``1/sqrt(hd)``,
mask value -1e30, softmax in f32, a cast to the compute dtype before the PV
product, and on local layers the window rule ``k > q - window``.

Serving (``prefill``, ``decode_step``; ``init_cache_unrolled`` /
``decode_step_unrolled`` with rolling window caches on local layers) is the
JAX package's with its model axis reduced to one device: the JAX
functions' ``dist`` and ``tp`` arguments have no counterpart, as in
``lm_loss``.  Each cast follows the JAX code: the head's product in the
compute dtype cast to f32 for the greedy argmax (the first maximal id wins
ties), f32 scores, and the softmax numerator cast to the compute dtype
before the value product.  A decode step writes the new position into the
cache it is given and returns that cache (the JAX function returns a new
one); decode attention is the same plain math as prefill's, as in the JAX
package, which has no Pallas kernel for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import apply_rope, dense_init, embed_init, rms_norm


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
    rope_theta: float = 1e6
    sliding_window: int | None = None  # window for local layers
    global_every: int = 0  # 0 = all layers global; k = layers k-1, 2k-1,... global
    moe: Any | None = None  # MoE FFN: not ported yet
    act: str = "silu"  # the only activation ported so far
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.bfloat16
    eps: float = 1e-6
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    seq_parallel: bool = False  # not ported yet

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
        """Exact parameter count (excluding vocab padding), dense FFN."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFNs are not ported yet")
    if cfg.seq_parallel:
        raise NotImplementedError("sequence parallelism is not ported yet")
    if cfg.act != "silu":
        raise NotImplementedError(f"activation {cfg.act!r} is not ported yet")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> dict:
    """Random parameters drawn from ``generator`` (a fresh one seeded 0 on
    ``device`` when None), laid out as the JAX package's tp=1 tree."""
    _check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    elif device is not None and torch.device(device).type != generator.device.type:
        raise ValueError(
            f"generator lives on {generator.device}, device is {device}")
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    pdt = cfg.param_dtype
    dev = generator.device
    qdim = cfg.n_heads * hd
    kvdim = cfg.n_kv_heads * hd

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=dev)

    layers: dict[str, Any] = {
        "ln1": zeros(L, d),
        "ln2": zeros(L, d),
        "wq": dense_init(generator, (L, d, qdim), d, pdt),
        "wk": dense_init(generator, (L, d, kvdim), d, pdt),
        "wv": dense_init(generator, (L, d, kvdim), d, pdt),
        "wo": dense_init(generator, (L, d, qdim), qdim, pdt)
        .transpose(1, 2).contiguous(),
    }
    layers["w1"] = dense_init(generator, (L, d, cfg.d_ff), d, pdt)
    layers["w3"] = dense_init(generator, (L, d, cfg.d_ff), d, pdt)
    layers["w2"] = dense_init(generator, (L, cfg.d_ff, d), cfg.d_ff, pdt)
    vp = cfg.vocab_padded(1)
    return {
        "embed": embed_init(generator, (vp, d), pdt),
        "layers": layers,
        "ln_f": zeros(d),
        "head": embed_init(generator, (vp, d), pdt),
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg: TransformerConfig):
    emb = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the JAX package does
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()
        emb = emb * scale
    return emb


def _qkv(x, lp, cfg: TransformerConfig, positions):
    """Returns q (B,S,H,hd) and k/v (B,S,Hkv,hd), q and k rope'd."""
    hd = cfg.head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(q, k, v, cfg: TransformerConfig, is_global: bool):
    """Causal (optionally windowed) attention.  q: (B, S, H, hd); k/v:
    (B, S, H, hd), already one kv head per q head."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]  # (q, k) causal
    if not is_global:
        win = cfg.sliding_window or s
        mask = mask & (pos[None, :] > pos[:, None] - win)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _kv_index(cfg: TransformerConfig, device) -> torch.Tensor:
    """The kv head serving each q head."""
    return torch.arange(cfg.n_heads, device=device) // cfg.q_group


def _attn_block(x, lp, cfg: TransformerConfig, is_global: bool, positions):
    """The attention output and the layer's k / v (B, S, Hkv, hd), which
    prefill keeps as its cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, lp, cfg, positions)
    kv_idx = _kv_index(cfg, x.device)
    out = _attention(q, k.index_select(2, kv_idx), v.index_select(2, kv_idx),
                     cfg, is_global)
    out = out.reshape(b, s, -1) @ lp["wo"]
    return out.to(x.dtype), k, v


def _ffn_block(x, lp, cfg: TransformerConfig):
    h = F.silu(x @ lp["w1"]) * (x @ lp["w3"])
    return (h @ lp["w2"]).to(x.dtype)


def _layer(x, lp, is_global: bool, cfg: TransformerConfig, positions):
    """One decoder layer: the new hidden states and the layer's k / v."""
    h = rms_norm(x, lp["ln1"], cfg.eps)
    out, k, v = _attn_block(h, lp, cfg, is_global, positions)
    x = x + out
    h = rms_norm(x, lp["ln2"], cfg.eps)
    return x + _ffn_block(h, lp, cfg), k, v


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> hidden (B, S, d) and the aux loss (0 for a dense
    FFN).

    The JAX package's ``jax.checkpoint`` around its layer body (``remat``)
    becomes nothing here: autograd keeps every layer's activations, about
    0.1 GB a layer for gemma3-1b at 1 x 1024 tokens, and no layer is
    recomputed."""
    _check_supported(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg)
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once, where indexing w[li] per layer would scatter each
    # layer's gradient into a zeroed (L, ...) buffer and sum L of them
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        x, _, _ = _layer(x, lp, cfg.is_global_layer(li), cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def lm_loss(params, tokens, labels, cfg: TransformerConfig):
    """Softmax cross-entropy over the full head (tp=1).  Returns the scalar
    mean loss and {"ce", "aux"}."""
    x, aux = forward(params, tokens, cfg)
    x = rms_norm(x, params["ln_f"], cfg.eps)
    head = params["head"]  # (V, d)
    logits = (x @ head.T).float()  # (B, S, V), in the compute dtype first
    vpad = head.shape[0]
    if vpad > cfg.vocab:  # mask vocab-padding rows out of the softmax
        live = torch.arange(vpad, device=logits.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    lab_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    # the stability max is gradient-free (d lse/d logits is the softmax)
    mx = torch.amax(logits.detach(), dim=-1)
    lse = mx + torch.log(torch.sum(torch.exp(logits - mx[..., None]), dim=-1))
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


def lm_loss_and_grad(params, tokens, labels, cfg: TransformerConfig):
    """(loss, grads): the loss of ``lm_loss`` and its gradient as a tree
    shaped like ``params`` (the port's ``jax.value_and_grad`` of it).

    Module-level tree helpers, not recursive closures: a closure that
    refers to itself is a reference cycle, and one holding the tracked
    leaves kept a worker's whole weight copy alive until the cyclic
    garbage collector happened to run."""
    tracked = _map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm_loss(tracked, tokens, labels, cfg)
    grads = iter(torch.autograd.grad(loss, _tree_leaves(tracked)))
    return loss.detach(), _map_tree(lambda _: next(grads), params)


# ---------------------------------------------------------------------------
# serving: prefill + decode with a full-length KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch_local: int, max_seq: int,
               device: torch.device | str | None = None) -> dict:
    """The decode cache: (L, B, max_seq, Hkv, hd) zeros in the compute
    dtype, on ``device`` (the card unless the caller passes another)."""
    shape = (cfg.n_layers, batch_local, max_seq, cfg.n_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _prefill_hidden(params, tokens, cfg: TransformerConfig, max_seq: int):
    """The final hidden states (B, S, d) and the cache of ``tokens``."""
    _check_supported(cfg)
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"{s} prompt tokens exceed max_seq={max_seq}")
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, b, max_seq, device=x.device)
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        x, k, v = _layer(x, lp, cfg.is_global_layer(li), cfg, positions)
        cache["k"][li, :, :s] = k
        cache["v"][li, :, :s] = v
    return x, cache


def prefill(params, tokens, cfg: TransformerConfig, max_seq: int):
    """Returns (greedy next-token ids (B,) int32, cache filled with the S
    prompt tokens and zero-padded to ``max_seq``)."""
    x, cache = _prefill_hidden(params, tokens, cfg, max_seq)
    return _greedy_logits(params, x[:, -1], cfg), cache


def head_logits(params, xlast, cfg: TransformerConfig) -> torch.Tensor:
    """f32 logits (B, Vpad) of final hidden states ``xlast`` (B, d): the
    head's product in the compute dtype, cast to f32, with the vocab
    padding masked to -1e30 (what ``_greedy_logits`` takes the argmax of)."""
    x = rms_norm(xlast, params["ln_f"], cfg.eps)
    head = params["head"]
    logits = (x @ head.T).float()
    gid = torch.arange(head.shape[0], device=logits.device)
    return torch.where(gid < cfg.vocab, logits, -1e30)


def _greedy_logits(params, xlast, cfg: TransformerConfig) -> torch.Tensor:
    """Greedy next token (B,) int32: the first maximal id."""
    return torch.argmax(head_logits(params, xlast, cfg), dim=-1).to(
        torch.int32)


def _decode_attn(q, k_cache, v_cache, pos: int, cfg: TransformerConfig,
                 is_global: bool = True):
    """One query position against the full-length cache (the JAX
    ``_decode_attn_distributed`` on one device).  q: (B, H, hd); caches:
    (B, S, Hkv, hd).  Local layers mask the window: the cache keeps every
    position for shape uniformity."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    kv_idx = _kv_index(cfg, q.device)
    k_used = k_cache.index_select(2, kv_idx)  # (B, S, H, hd)
    v_used = v_cache.index_select(2, kv_idx)
    gpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = gpos <= pos
    if cfg.sliding_window is not None and not is_global:
        valid = valid & (gpos > pos - cfg.sliding_window)
    scores = torch.einsum("bhd,bshd->bhs", q, k_used).float() * scale
    scores = torch.where(valid[None, None, :], scores, -1e30)
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None])
    den = torch.sum(e, dim=-1)
    num = torch.einsum("bhs,bshd->bhd", e.to(q.dtype), v_used).float()
    return (num / den[..., None]).to(q.dtype)


def _decode_layer_out(x, lp, cfg: TransformerConfig, attn) -> torch.Tensor:
    """One decoder layer for one position: ``attn(h)`` is the attention
    output (B, H, hd) of the normed input ``h`` (B, d)."""
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.eps)
    out = attn(h).reshape(b, -1) @ lp["wo"]
    x = x + out.to(x.dtype)
    h = rms_norm(x, lp["ln2"], cfg.eps)
    return x + _ffn_block(h[:, None], lp, cfg)[:, 0]


def _decode_qkv(h, lp, cfg: TransformerConfig, pos: int):
    b = h.shape[0]
    positions = torch.full((b, 1), pos, device=h.device)
    q, k, v = _qkv(h[:, None], lp, cfg, positions)
    return q[:, 0], k[:, 0], v[:, 0]


def decode_hidden(params, token, cache, pos, cfg: TransformerConfig):
    """The final hidden state (B, d) of one decode step; writes position
    ``pos`` of every layer's cache in place."""
    _check_supported(cfg)
    pos = int(pos)
    x = _embed(params, token[:, None], cfg)[:, 0]  # (B, d)
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        kc, vc = cache["k"][li], cache["v"][li]

        def attn(h, lp=lp, kc=kc, vc=vc, li=li):
            q, k, v = _decode_qkv(h, lp, cfg, pos)
            kc[:, pos] = k
            vc[:, pos] = v
            return _decode_attn(q, kc, vc, pos, cfg, cfg.is_global_layer(li))

        x = _decode_layer_out(x, lp, cfg, attn)
    return x


def decode_step(params, token, cache, pos, cfg: TransformerConfig):
    """One greedy decode step.  token (B,) int; ``pos``: the count of
    tokens already in the cache.  Returns (next token (B,) int32, the
    cache, updated in place at ``pos``)."""
    x = decode_hidden(params, token, cache, pos, cfg)
    return _greedy_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# unrolled decode with per-layer cache sizes (sliding-window archs, long ctx)
# ---------------------------------------------------------------------------

def init_cache_unrolled(cfg: TransformerConfig, batch_local: int,
                        max_seq: int,
                        device: torch.device | str | None = None) -> list:
    """Per-layer caches: a rolling window for local layers, full length
    for global ones, zeros in the compute dtype on ``device``."""
    dev = resolve_device(device)
    caches = []
    for li in range(cfg.n_layers):
        s = max_seq if cfg.is_global_layer(li) else cfg.sliding_window
        shape = (batch_local, s, cfg.n_kv_heads, cfg.head_dim)
        caches.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)})
    return caches


def _window_decode_attn(q, k_roll, v_roll, pos: int, cfg: TransformerConfig):
    """Attention over a rolling window cache: slot ``p % w`` holds
    position ``p``."""
    hd = q.shape[-1]
    w = k_roll.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kv_idx = _kv_index(cfg, q.device)
    k_used = k_roll.index_select(2, kv_idx)
    v_used = v_roll.index_select(2, kv_idx)
    slot_age = torch.remainder(pos % w - torch.arange(w, device=q.device), w)
    valid = slot_age <= min(pos, w - 1)
    scores = torch.einsum("bhd,bshd->bhs", q, k_used).float() * scale
    scores = torch.where(valid[None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", p, v_used)


def decode_hidden_unrolled(params, token, caches, pos,
                           cfg: TransformerConfig):
    """``decode_hidden`` over ``init_cache_unrolled``'s per-layer caches:
    global layers write position ``pos``, local layers slot
    ``pos % window``, in place."""
    _check_supported(cfg)
    pos = int(pos)
    x = _embed(params, token[:, None], cfg)[:, 0]
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.n_layers):
        lp = {name: ws[li] for name, ws in per_layer.items()}
        kc, vc = caches[li]["k"], caches[li]["v"]
        glob = cfg.is_global_layer(li)

        def attn(h, lp=lp, kc=kc, vc=vc, glob=glob):
            q, k, v = _decode_qkv(h, lp, cfg, pos)
            slot = pos if glob else pos % kc.shape[1]
            kc[:, slot] = k
            vc[:, slot] = v
            if glob:
                return _decode_attn(q, kc, vc, pos, cfg)
            return _window_decode_attn(q, kc, vc, pos, cfg)

        x = _decode_layer_out(x, lp, cfg, attn)
    return x


def decode_step_unrolled(params, token, caches, pos,
                         cfg: TransformerConfig):
    """Decode with heterogeneous per-layer caches (gemma3 long context).
    Returns (next token (B,) int32, the caches, updated in place)."""
    x = decode_hidden_unrolled(params, token, caches, pos, cfg)
    return _greedy_logits(params, x, cfg), caches
