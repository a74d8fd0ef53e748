"""EquiformerV2 (arXiv:2306.12059) in plain PyTorch: the benchmark's
reference for the ``equiformer-v2`` configuration, graph regression.

A frozen copy of the one-rank forward pass and loss of
``src/repro_torch/models/gnn/equiformer_v2.py`` (no tensor, edge or node
parallelism, no collectives): node features are real-SH irreps
(N, (l_max+1)^2, C); each edge's message is rotated into the
edge-aligned frame by its packed Wigner blocks, where the SO(3) tensor
product reduces to SO(2) linear maps over |m| <= m_max, gated by the
radial basis; attention over the incoming edges (a segment softmax, heads
mapped onto channel blocks); an RMS norm per degree; a gated FFN.  The
readout sums each molecule's l=0 outputs.  ``remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``), which changes no
value.  The precision of the products is set by ``reference.precision``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def param_spec(cfg: dict) -> dict:
    """Each leaf's kind, shape and fan-in (``yardstick.inputs.make_params``)."""
    c, L, n0 = cfg["channels"], cfg["n_layers"], cfg["l_max"] + 1

    def so2(n_l):
        return ("normal", (L, n_l, c, n_l, c), n_l * c)

    layers = {
        "w0": so2(n0),
        "gate_rbf": ("normal", (L, cfg["n_rbf"], cfg["m_max"] + 1),
                     cfg["n_rbf"]),
        "w_att": ("normal", (L, n0, c, cfg["n_heads"]), n0 * c),
        "w_upd": ("normal", (L, c, c), c),
        "ln_a": ("ones", (L, n0)),
        "ln_f": ("ones", (L, n0)),
        "f1": ("normal", (L, c, 2 * c), c),
        "f_gate": ("normal", (L, c, 2 * c), c),
        "f2": ("normal", (L, 2 * c, c), 2 * c),
    }
    for m in range(1, cfg["m_max"] + 1):
        layers[f"wr{m}"] = so2(n0 - m)
        layers[f"wi{m}"] = so2(n0 - m)
    return {"embed": ("normal", (cfg["d_in"], c), cfg["d_in"]),
            "layers": layers,
            "head": ("normal", (c, cfg["n_out"]), c)}


def _m_idx(cfg: dict):
    L = cfg["l_max"]
    m0 = [l * l + l for l in range(L + 1)]
    mp = {m: [l * l + l + m for l in range(m, L + 1)]
          for m in range(1, cfg["m_max"] + 1)}
    mn = {m: [l * l + l - m for l in range(m, L + 1)]
          for m in range(1, cfg["m_max"] + 1)}
    return m0, mp, mn


def _rotate(x, wigner, l_max: int, inverse: bool = False):
    outs, off = [], 0
    for l in range(l_max + 1):
        w = 2 * l + 1
        d = wigner[:, off:off + w * w].reshape(-1, w, w)
        off += w * w
        outs.append(torch.bmm(d.transpose(1, 2) if inverse else d,
                              x[:, l * l:l * l + w]))
    return torch.cat(outs, dim=1)


def _norm(x, scale, l_max: int, eps: float = 1e-6):
    outs = []
    for l in range(l_max + 1):
        xl = x[:, l * l:(l + 1) ** 2]
        ss = torch.mean(xl ** 2, dim=(1, 2), keepdim=True)
        outs.append(xl * torch.rsqrt(ss + eps) * scale[l])
    return torch.cat(outs, dim=1)


def _segment_sum(x, ids, n: int):
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, ids, x)


def _segment_softmax(logits, ids, n: int):
    lg = logits.detach()
    mx = torch.full((n, lg.shape[1]), float("-inf"), dtype=lg.dtype,
                    device=lg.device)
    mx = mx.scatter_reduce(0, ids.long()[:, None].expand_as(lg), lg, "amax",
                           include_self=False)
    mx = torch.nan_to_num(mx, neginf=0.0)
    e = torch.exp(logits - mx.index_select(0, ids))
    den = _segment_sum(e, ids, n)
    return e / torch.clamp(den.index_select(0, ids), min=1e-9)


def _so2(xr, w):
    e, n_l, c = xr.shape
    return (xr.reshape(e, n_l * c) @ w.reshape(n_l * c, -1)).reshape(e, n_l, -1)


def _layer(x, lp: dict, graph: dict, cfg: dict):
    L, c = cfg["l_max"], cfg["channels"]
    m0, mp, mn = _m_idx(cfg)
    dev = x.device
    src, dst = graph["edge_src"], graph["edge_dst"]
    wig, emask = graph["wigner"], graph["edge_mask"]
    n = x.shape[0]

    h = _norm(x, lp["ln_a"], L)
    mr = _rotate(h.index_select(0, src) + h.index_select(0, dst), wig, L)
    gates = graph["rbf"] @ lp["gate_rbf"]
    idxs = list(m0)
    vals = [_so2(mr[:, m0], lp["w0"]) * gates[:, 0, None, None]]
    for m in range(1, cfg["m_max"] + 1):
        xp, xn = mr[:, mp[m]], mr[:, mn[m]]
        g = gates[:, m, None, None]
        vals.append((_so2(xp, lp[f"wr{m}"]) - _so2(xn, lp[f"wi{m}"])) * g)
        vals.append((_so2(xp, lp[f"wi{m}"]) + _so2(xn, lp[f"wr{m}"])) * g)
        idxs += mp[m] + mn[m]
    conv = torch.zeros((mr.shape[0], (L + 1) ** 2, c), dtype=x.dtype,
                       device=dev).index_copy(
        1, torch.tensor(idxs, device=dev), torch.cat(vals, dim=1))
    inv = F.leaky_relu(conv[:, m0], 0.01)
    logits = inv.reshape(inv.shape[0], -1) @ lp["w_att"].reshape(
        -1, cfg["n_heads"])
    logits = torch.where(emask[:, None] != 0, logits,
                         torch.full_like(logits, -1e30))
    att = _segment_softmax(logits, dst, n)
    head_of_c = torch.arange(c, device=dev) // (c // cfg["n_heads"])
    val = _rotate(conv, wig, L, inverse=True)
    val = val * att.index_select(1, head_of_c)[:, None, :] * emask[:, None, None]
    x = x + _segment_sum(val, dst, n) @ lp["w_upd"]
    h = _norm(x, lp["ln_f"], L)
    hid = (h @ lp["f1"]) * torch.sigmoid(h[:, 0:1] @ lp["f_gate"])
    return x + hid @ lp["f2"]


def forward(params: dict, graph: dict, cfg: dict, remat: bool = False):
    """The irreps of every node after the last layer, (N, K, C)."""
    x0 = graph["node_feat"] @ params["embed"]
    n, c = x0.shape
    x = torch.cat([x0[:, None], torch.zeros(
        (n, (cfg["l_max"] + 1) ** 2 - 1, c), dtype=x0.dtype,
        device=x0.device)], dim=1)
    names = tuple(params["layers"])

    def layer(x, *weights):
        return _layer(x, dict(zip(names, weights)), graph, cfg)

    for li in range(cfg["n_layers"]):
        weights = [params["layers"][k][li] for k in names]
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *weights, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, *weights)
    return x


def loss(params: dict, graph: dict, cfg: dict, remat: bool = False):
    """Masked mean squared error of each molecule's summed energy."""
    out = forward(params, graph, cfg, remat)[:, 0] @ params["head"]
    targets = graph["targets"]
    energy = _segment_sum(out[:, 0] * graph["node_mask"], graph["graph_ids"],
                          targets.shape[0])
    err = energy - targets
    gmask = graph["graph_mask"]
    return torch.sum(err * err * gmask) / torch.clamp(gmask.sum(), min=1.0)
