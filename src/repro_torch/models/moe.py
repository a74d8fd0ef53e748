"""Mixture-of-Experts FFN with capacity-based argsort dispatch (torch
counterpart of ``repro/models/moe.py``).

Experts are tensor-parallel over the ``model`` axis: every rank holds a
1/tp slice of every expert's hidden dim, routing and dispatch are computed
identically on every rank, the expert products give partial outputs, and
the caller's one ``psum`` (shared with the dense path) completes the
block.  The router is replicated and runs in f32.

Dispatch is the GShard/Switch capacity pattern built from a stable sort
(no (T, E, C) one-hot): assignments sorted by expert, each one's rank
within its expert, overflow beyond the capacity dropped, tokens gathered
into an (E, C, d) buffer and the outputs gathered back.

Three rules make the port's bits the reference's:

* top-k ties: ``lax.top_k`` puts the lower expert first; ``torch.topk``
  promises no order on ties, so ``route_topk`` takes the first k of a
  stable descending sort.
* the scratch row: the reference scatters every dropped assignment's zero
  row into buffer row ``E*C - 1``, which is also a real slot (rank C-1 of
  expert E-1).  XLA applies duplicate writes in order, so that row ends as
  zeros whenever a dropped assignment comes after the kept one there (the
  kept token then loses that expert's output, and its gradient through
  it).  The port fills the buffer by a gather from the sorted order, with
  no duplicate writes, and zeros that row by the same rule.
* the combine: ``jax.ops.segment_sum`` over the token of each assignment.
  Every token owns k consecutive assignments, so it is a left fold over k
  in XLA's order, with no atomics on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import Dist, act_fn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_d_ff: int = 0  # 0 = no shared expert
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"

    def capacity(self, tokens: int) -> int:
        c = int(self.capacity_factor * tokens * self.top_k / self.n_experts)
        return max(8, -(-c // 8) * 8)


def route_topk(logits: torch.Tensor, cfg: MoEConfig):
    """logits (T, E) -> (weights (T, k) f32, experts (T, k) int64, the
    Switch load-balance aux loss, a scalar)."""
    x = logits.float()
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True).detach())
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = srt[:, :cfg.top_k], order[:, :cfg.top_k]
    vals = vals / torch.clamp(torch.sum(vals, dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    t = logits.shape[0]
    first = torch.sort(idx[:, 0]).values
    counts = _counts(first, cfg.n_experts)
    f = counts.float() / t
    p = torch.mean(probs, dim=0)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(f * p)
    return vals, idx, aux


def _counts(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of 0..n-1 in a sorted id vector, by binary search (no
    atomics on the card)."""
    edges = torch.arange(n + 1, device=sorted_ids.device,
                         dtype=sorted_ids.dtype)
    return torch.diff(torch.searchsorted(sorted_ids, edges))


def _dispatch(experts: torch.Tensor, cfg: MoEConfig, capacity: int):
    """experts (T, k) -> (buf_pos, keep, assign, filled), from one stable
    sort of the flattened assignments by expert.

    ``buf_pos`` / ``keep`` (T*k,): each assignment's row of the flattened
    (E*C) expert buffer (0 where dropped) and whether it fits under the
    capacity.  ``assign`` / ``filled`` (E*C,): the reference's scatter
    inverted, the assignment each buffer row holds (row ``e*C + r`` holds
    the r-th assignment of expert e in sorted order, if it has one).  The
    last row doubles as the reference's scratch row: it stays filled only
    if no dropped assignment comes after the kept one there."""
    flat_e = experts.reshape(-1)
    tk = flat_e.numel()
    dev = flat_e.device
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = _counts(sorted_e, cfg.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    idx = torch.arange(tk, device=dev)
    rank = torch.empty_like(idx)
    rank[order] = idx - starts[sorted_e]  # order is a permutation
    keep = rank < capacity
    buf_pos = torch.where(keep, flat_e * capacity + rank, 0)

    r = torch.arange(capacity, device=dev)
    assign = order[(starts[:, None] + r).reshape(-1).clamp(max=tk - 1)]
    filled = (r[None, :] < counts[:, None]).reshape(-1)
    last_dropped = torch.amax(torch.where(keep, -1, idx))
    last_kept = filled[-1] & (last_dropped < assign[-1])
    filled = torch.cat([filled[:-1], last_kept.reshape(1)])
    return buf_pos, keep, assign, filled


def dispatch_indices(experts: torch.Tensor, cfg: MoEConfig, capacity: int):
    """experts (T, k) -> (buf_pos (T*k,), keep (T*k,)): each assignment's
    row of the flattened (E*C) expert buffer (0 where dropped) and whether
    it fits under the capacity."""
    buf_pos, keep, _, _ = _dispatch(experts, cfg, capacity)
    return buf_pos, keep


def moe_ffn(x: torch.Tensor, weights: dict, cfg: MoEConfig,
            dist: Dist | None = None, act: str = "silu"):
    """x (T, d) tokens; ``weights``: router (d, E), we1 / we3 (E, d,
    Fe_loc), we2 (E, Fe_loc, d), optional ws1 / ws3 (d, Fs_loc) and ws2
    (Fs_loc, d).  Returns (the partial output (T, d), which the caller
    sums over the model axis, the aux loss)."""
    t, d = x.shape
    k = cfg.top_k
    logits = x.float() @ weights["router"].float()
    gate_w, gate_e, aux = route_topk(logits, cfg)

    capacity = cfg.capacity(t)
    buf_pos, keep, assign, filled = _dispatch(gate_e, cfg, capacity)
    buf = torch.where(filled[:, None], x[assign // k], 0).to(x.dtype)
    buf = buf.reshape(cfg.n_experts, capacity, d)

    a = act_fn(act)
    h = a(torch.matmul(buf, weights["we1"])) * torch.matmul(buf,
                                                             weights["we3"])
    out_buf = torch.matmul(h, weights["we2"]).reshape(-1, d)

    # combine: the weighted gather back to tokens, a left fold over k
    scale = (gate_w.reshape(-1) * keep)[:, None].to(x.dtype)
    per_assign = (out_buf[buf_pos] * scale).reshape(t, k, d)
    out = per_assign[:, 0]
    for j in range(1, k):
        out = out + per_assign[:, j]

    if cfg.shared_d_ff:
        hs = a(x @ weights["ws1"]) * (x @ weights["ws3"])
        out = out + hs @ weights["ws2"]
    return out.to(x.dtype), aux
