"""EquiformerV2 backbone: eSCN SO(2) equivariant graph attention (torch
counterpart of ``repro/models/gnn/equiformer_v2.py``), per rank.

Structure (arXiv:2306.12059), as in the JAX package:

  * node features are real-SH irreps x: (N, (l_max+1)^2, C)
  * per edge, features are rotated into the edge-aligned frame by
    precomputed Wigner blocks (``data/graphs.py``); there the SO(3) tensor
    product reduces to SO(2) linear maps over the |m| <= m_max components
  * graph attention (``n_heads`` heads) with a segment softmax over the
    incoming edges
  * an RMS norm per degree l and a gated irrep FFN

Parameters are a nested ``dict[str, Tensor]`` with the JAX package's keys
and global shapes, stacked over layers, so the two packages' trees flatten
to the same chunk space.  Every function takes the rank's local pieces and
a ``models/common.Dist``.  The branches on ``dist.model_axis is not None``
go the way JAX's do; a model axis of one rank makes every collective the
identity, as JAX's are over a one-device axis.  Three parallel regimes:

  * channel tensor parallelism: input channels sharded over the ``model``
    axis, every channel-mixing linear ``partial @ W`` followed by a
    psum-scatter over the output channels;
  * edge parallelism (``edge_parallel``): channels whole, edges sharded
    over the ``model`` axis, one node-sized psum a layer;
  * node-sharded full graphs (``forward(dist_nodes=True)``): node rows
    sharded over the data axes, ``edge_src`` global and ``edge_dst``
    local, the source rows all-gathered every layer.

Dtypes follow JAX's promotion, op by op: a bf16 operand meets an f32
parameter or Wigner block in f32 (torch refuses mixed dtypes in a product,
so each operand is cast to the promoted dtype), and the carry goes back to
``cfg.dtype`` where JAX's ``astype`` puts it.  The products are
``torch.matmul`` / ``torch.bmm``; the gathers and segment reductions are
``index_select``, ``index_add`` and ``scatter_reduce``.  The JAX package
has no Pallas kernel for any of it (they are XLA ops there).  ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, JAX's
``jax.checkpoint`` of the scanned layer body).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch._dynamo  # noqa: F401  (as in models/transformer.py)
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import Dist, dense_init, gen_device


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    d_in: int = 128  # input node feature dim
    n_out: int = 1
    task: str = "node_class"  # "node_class" | "graph_reg"
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # channels whole and the model axis sharding *edges* (see the module
    # docstring); params replicated over the model axis (tag "psum_model")
    edge_parallel: bool = False

    @property
    def num_coef(self) -> int:
        return (self.l_max + 1) ** 2

    # --- static m-restricted index plans (eSCN layout) ---
    def m0_idx(self):
        return [l * l + l for l in range(self.l_max + 1)]

    def mp_idx(self, m):
        return [l * l + l + m for l in range(m, self.l_max + 1)]

    def mn_idx(self, m):
        return [l * l + l - m for l in range(m, self.l_max + 1)]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: EquiformerConfig, generator: torch.Generator | None = None,
                tp: int = 1, device: torch.device | str | None = None) -> dict:
    """Random parameters with the JAX init's tree and global shapes (``tp``
    is accepted as JAX's is and changes nothing), drawn from ``generator``
    on its device in the JAX init's order; ``generator=None`` or
    ``device="meta"`` gives meta tensors (shapes and dtypes only)."""
    del tp
    if device is not None and torch.device(device).type == "meta":
        generator = None
    elif (generator is not None and device is not None
          and torch.device(device).type != generator.device.type):
        raise ValueError(
            f"generator lives on {generator.device}, device is {device}")
    c, L, pdt = cfg.channels, cfg.n_layers, cfg.param_dtype
    n0 = cfg.l_max + 1

    def dense(shape, in_dim):
        return dense_init(generator, shape, in_dim, pdt)

    def so2_w(n_l):
        # (n_l, C, n_l, C): in-(degree, channel) -> out-(degree, channel)
        return dense((L, n_l, c, n_l, c), n_l * c)

    params = {
        "embed": dense((cfg.d_in, c), cfg.d_in),
        "layers": {
            "w0": so2_w(n0),
            "gate_rbf": dense((L, cfg.n_rbf, cfg.m_max + 1), cfg.n_rbf),
            "w_att": dense((L, n0, c, cfg.n_heads), n0 * c),
            "w_upd": dense((L, c, c), c),
            "ln_a": torch.ones((L, n0), dtype=pdt,
                               device=gen_device(generator)),
            "ln_f": torch.ones((L, n0), dtype=pdt,
                               device=gen_device(generator)),
            "f1": dense((L, c, 2 * c), c),
            "f_gate": dense((L, c, 2 * c), c),
            "f2": dense((L, 2 * c, c), 2 * c),
        },
        "head": dense((c, cfg.n_out), c),
    }
    for m in range(1, cfg.m_max + 1):
        n_l = cfg.l_max + 1 - m
        params["layers"][f"wr{m}"] = so2_w(n_l)
        params["layers"][f"wi{m}"] = so2_w(n_l)
    return params


def make_param_specs(cfg: EquiformerConfig, tp: int, axis: str = "model") -> dict:
    """Each parameter's sharding as JAX's ``PartitionSpec`` names it (a
    tuple of an axis name or None per dimension, ``()`` replicated): the
    input channels over the model axis, nothing under edge parallelism."""
    M = axis if (tp > 1 and not cfg.edge_parallel) else None
    so2 = (None, None, M, None, None)  # shard input channels
    layers: dict[str, Any] = {
        "w0": so2,
        "gate_rbf": (),
        "w_att": (None, None, M, None),
        "w_upd": (None, M, None),
        "ln_a": (),
        "ln_f": (),
        "f1": (None, M, None),
        "f_gate": (None, M, None),
        "f2": (None, M, None),
    }
    for m in range(1, cfg.m_max + 1):
        layers[f"wr{m}"] = so2
        layers[f"wi{m}"] = so2
    return {"embed": (None, M), "layers": layers, "head": (M, None)}


def grad_sync(cfg: EquiformerConfig, tp: int) -> dict:
    """The JAX function's tags: under edge parallelism every gradient is
    summed over the model axis (each rank's covers its edge shard's
    paths); under channel TP the replicated gates and norms are."""
    if cfg.edge_parallel and tp > 1:
        specs = make_param_specs(cfg, 1)
        return {"embed": "psum_model", "head": "psum_model",
                "layers": {k: "psum_model" for k in specs["layers"]}}
    rep = "psum_model" if tp > 1 else "none"
    layers = {k: "none" for k in [
        "w0", "w_att", "w_upd", "ln_a", "ln_f", "f1", "f_gate", "f2"]}
    layers["gate_rbf"] = rep
    layers["ln_a"] = rep
    layers["ln_f"] = rep
    for m in range(1, cfg.m_max + 1):
        layers[f"wr{m}"] = "none"
        layers[f"wi{m}"] = "none"
    return {"embed": "none", "layers": layers, "head": "none"}


# ---------------------------------------------------------------------------
# building blocks (per rank; channels sharded C_loc = C/tp)
# ---------------------------------------------------------------------------

def _promoted(*xs):
    """The operands cast to their promoted dtype (JAX's ``@`` / ``einsum``
    promote a bf16 x f32 product to f32; torch's refuse it)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mix(x, w, dist: Dist):
    """Channel-mixing linear: x (..., C_loc_in) @ w (C_loc_in, C_out) ->
    psum-scatter over the output channel dim -> (..., C_out/tp)."""
    x, w = _promoted(x, w)
    y = x @ w
    if dist.model_axis is None:
        return y
    return dist.psum_scatter_model(y, y.dim() - 1)


def _so2_apply(xr, w, dist: Dist):
    """SO(2) block: xr (E, n_l, C_loc) x w (n_l, C_loc, n_l, C) ->
    (E, n_l, C/tp)."""
    xr, w = _promoted(xr, w)
    e, n_l, cin = xr.shape
    y = (xr.reshape(e, n_l * cin) @ w.reshape(n_l * cin, -1)).reshape(
        e, n_l, -1)
    if dist.model_axis is None:
        return y
    return dist.psum_scatter_model(y, 2)


def _rotate(x, wigner, cfg: EquiformerConfig, inverse: bool = False):
    """x (E, K, C) rotated per edge by packed Wigner blocks (E, packed)."""
    x, wigner = _promoted(x, wigner)
    outs = []
    off = 0
    for l in range(cfg.l_max + 1):
        w = 2 * l + 1
        d = wigner[:, off:off + w * w].reshape(-1, w, w)
        off += w * w
        xl = x[:, l * l:l * l + w]
        outs.append(torch.bmm(d.transpose(1, 2) if inverse else d, xl))
    return torch.cat(outs, dim=1)


def _equiv_norm(x, scale, cfg: EquiformerConfig, dist: Dist, eps=1e-6):
    """RMS norm per degree l over (m, all channels); scale (l_max+1,)."""
    outs = []
    for l in range(cfg.l_max + 1):
        xl = x[:, l * l:(l + 1) ** 2]
        ss = torch.mean(xl.float() ** 2, dim=(1, 2), keepdim=True)
        if dist.model_axis is not None:
            ss = dist.psum_model(ss) * (1.0 / dist.tp)  # lax.pmean
        y = xl.float() * torch.rsqrt(ss + eps) * scale[l].float()
        outs.append(y.to(x.dtype))
    return torch.cat(outs, dim=1)


def _segment_sum(x, seg_ids, num_segments: int):
    """``jax.ops.segment_sum``: rows of ``x`` summed by segment id."""
    out = torch.zeros((num_segments, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, seg_ids, x)


def _segment_softmax(logits, seg_ids, num_segments: int,
                     dist: Dist | None = None):
    """Softmax over incoming edges; with ``dist`` the edge set is sharded
    over the model axis and the max/sum reduce across shards.  An empty
    segment's max is -inf (``segment_max``), which becomes 0."""
    lg = logits.detach()
    idx = seg_ids.long()[:, None].expand_as(lg)
    mx = torch.full((num_segments, lg.shape[1]), float("-inf"),
                    dtype=lg.dtype, device=lg.device)
    mx = mx.scatter_reduce(0, idx, lg, "amax", include_self=False)
    mx = torch.nan_to_num(mx, neginf=0.0)
    if dist is not None and dist.model_axis is not None:
        mx = dist.pmax_model(mx)
    e = torch.exp(logits - mx.index_select(0, seg_ids))
    den = _segment_sum(e, seg_ids, num_segments)
    if dist is not None and dist.model_axis is not None:
        den = dist.psum_model(den)
    return e / torch.clamp(den.index_select(0, seg_ids), min=1e-9)


def _so2_conv(xr, lp, rbf, cfg: EquiformerConfig, dist: Dist):
    """eSCN conv in the rotated frame: per |m| <= m_max SO(2) linear maps,
    distance-gated.  xr (E, K, C_loc) -> (E, K, C_loc)."""
    e = xr.shape[0]
    rbf_, g_w = _promoted(rbf, lp["gate_rbf"])
    gates = rbf_ @ g_w  # (E, m_max+1)
    dev = xr.device
    m0 = torch.tensor(cfg.m0_idx(), device=dev)
    y0 = _so2_apply(xr.index_select(1, m0), lp["w0"], dist) * gates[:, 0, None, None]
    idxs, vals = [cfg.m0_idx()], [y0]
    for m in range(1, cfg.m_max + 1):
        xp = xr.index_select(1, torch.tensor(cfg.mp_idx(m), device=dev))
        xn = xr.index_select(1, torch.tensor(cfg.mn_idx(m), device=dev))
        yr_p = (_so2_apply(xp, lp[f"wr{m}"], dist)
                - _so2_apply(xn, lp[f"wi{m}"], dist))
        yr_n = (_so2_apply(xp, lp[f"wi{m}"], dist)
                + _so2_apply(xn, lp[f"wr{m}"], dist))
        g = gates[:, m, None, None]
        idxs += [cfg.mp_idx(m), cfg.mn_idx(m)]
        vals += [yr_p * g, yr_n * g]
    cloc = y0.shape[-1]
    # the components |m| > m_max stay zero; each index is set once
    idx = torch.tensor([i for ix in idxs for i in ix], device=dev)
    val = torch.cat([v.to(xr.dtype) for v in vals], dim=1)
    buf = torch.zeros((e, cfg.num_coef, cloc), dtype=xr.dtype, device=dev)
    return buf.index_copy(1, idx, val)


def _layer(x, lp, graph, cfg: EquiformerConfig, dist: Dist, gather_nodes):
    """One EquiformerV2 block.  x (N_loc, K, C_loc).

    edge_parallel: channels whole (``cdist`` makes every channel mix a
    local product), edges sharded over the model axis; the segment-softmax
    stats and the per-dst aggregate psum across edge shards."""
    ep = cfg.edge_parallel and dist.model_axis is not None
    cdist = Dist.none() if ep else dist
    src, dst = graph["edge_src"], graph["edge_dst"]
    wig, rbf = graph["wigner"], graph["rbf"]
    emask = graph["edge_mask"]
    n_loc = x.shape[0]
    cloc = x.shape[2]

    h = _equiv_norm(x, lp["ln_a"], cfg, cdist)
    msg_in = gather_nodes(h, src) + h.index_select(0, dst)
    # rotate into edge frame, SO(2) conv, attention stats
    mr = _rotate(msg_in, wig, cfg)
    conv = _so2_conv(mr, lp, rbf, cfg, cdist)  # (E, K, C_loc)
    # attention logits from the m=0 (invariant) components
    inv = conv.index_select(1, torch.tensor(cfg.m0_idx(), device=x.device))
    inv, w_att = _promoted(F.leaky_relu(inv, 0.01), lp["w_att"])
    e = inv.shape[0]
    logits = inv.reshape(e, -1) @ w_att.reshape(-1, w_att.shape[-1])
    if not ep and dist.model_axis is not None:
        logits = dist.psum_model(logits)
    logits = torch.where(emask[:, None] != 0, logits,
                         torch.full_like(logits, -1e30))
    att = _segment_softmax(logits, dst, n_loc, dist if ep else None)  # (E, H)
    # map attention heads onto local channels
    midx = 0 if ep else dist.model_index()
    gcid = midx * cloc + torch.arange(cloc, device=x.device)
    head_of_c = gcid // (cfg.channels // cfg.n_heads)
    a_ch = att.index_select(1, head_of_c)  # (E, C_loc)
    # rotate back and aggregate
    val = _rotate(conv, wig, cfg, inverse=True)
    val = val * a_ch[:, None, :] * emask[:, None, None]
    agg = _segment_sum(val, dst, n_loc)
    if ep:
        # the one model-axis collective a layer: node-sized, not edge-sized
        agg = dist.psum_model(agg)
    x = x + _mix(agg, lp["w_upd"], cdist).to(x.dtype)

    # gated irrep FFN
    h = _equiv_norm(x, lp["ln_f"], cfg, cdist)
    hid = _mix(h, lp["f1"], cdist)  # (N, K, 2C/tp)
    gate = torch.sigmoid(_mix(h[:, 0:1], lp["f_gate"], cdist))  # l=0 scalars
    hid = hid * gate
    return x + _mix(hid, lp["f2"], cdist).to(x.dtype)


def _layer_fn(x, names, graph, cfg, dist, gather_nodes, *weights):
    """``_layer`` with the layer's weights as arguments (what
    ``checkpoint`` recomputes)."""
    return _layer(x, dict(zip(names, weights)), graph, cfg, dist,
                  gather_nodes)


def _gather_fn(cfg: EquiformerConfig, dist: Dist, dist_nodes: bool):
    ep = cfg.edge_parallel and dist.model_axis is not None
    if dist_nodes and dist.data_axes:
        if ep:
            # node shards carry full channels (edge-parallel); gathering
            # them whole would cost tp x the channel-sharded baseline —
            # instead gather a channel slice, take the edge rows, and
            # restore channels on the (much smaller) edge set.
            def gather_nodes(h, src):
                cs = h.shape[2] // dist.tp
                j = dist.model_index()
                hs = h[:, :, j * cs:(j + 1) * cs]
                h_all = dist.all_gather_data(hs, axis=0)  # (N, K, C/tp)
                rows = h_all.index_select(0, src)
                return dist.all_gather_model(rows, axis=2)  # (E_loc, K, C)
        else:
            def gather_nodes(h, src):
                return dist.all_gather_data(h, axis=0).index_select(0, src)
    else:
        def gather_nodes(h, src):
            return h.index_select(0, src)
    return gather_nodes


def forward(params, graph, cfg: EquiformerConfig, dist: Dist | None = None,
            dist_nodes: bool = False):
    """graph: node_feat (N_loc, d_in), edge_src/dst, wigner, rbf, masks.

    dist_nodes: nodes sharded over the data axes (full-graph-large mode);
    source indices are then *global* and features are all-gathered per
    layer.  With ``remat`` (and autograd on) each layer keeps only its
    input and is recomputed in the backward."""
    dist = Dist.none() if dist is None else dist
    feat, embed = _promoted(graph["node_feat"].to(cfg.dtype), params["embed"])
    # column-parallel input embedding: output channels sharded, no collective
    x0 = feat @ embed  # (N_loc, C_loc) l=0 channels
    n_loc, cloc = x0.shape
    x = torch.cat([x0.to(cfg.dtype)[:, None],
                   torch.zeros((n_loc, cfg.num_coef - 1, cloc),
                               dtype=cfg.dtype, device=x0.device)], dim=1)
    gather_nodes = _gather_fn(cfg, dist, dist_nodes)
    # one unbind per stacked weight (as models/transformer._per_layer)
    per_layer = {k: w.unbind(0) for k, w in params["layers"].items()}
    names = tuple(per_layer)
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.n_layers):
        args = (x, names, graph, cfg, dist, gather_nodes,
                *(per_layer[n][li] for n in names))
        if remat:
            x = checkpoint(_layer_fn, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer_fn(*args)
    return x


def loss_fn(params, graph, cfg: EquiformerConfig, dist: Dist | None = None,
            dist_nodes: bool = False):
    """(loss / tp, metrics): node classification (masked mean cross-entropy,
    accuracy) or graph regression (segment-sum readout, masked MSE)."""
    dist = Dist.none() if dist is None else dist
    x = forward(params, graph, cfg, dist, dist_nodes)
    inv, head = _promoted(x[:, 0], params["head"])  # (N_loc, C_loc)
    out = inv @ head  # partial (N_loc, n_out)
    if dist.model_axis is not None and not cfg.edge_parallel:
        out = dist.psum_model(out)
    nmask = graph["node_mask"]
    # the per-rank loss is replicated over the model axis -> divide by tp
    # so the sum over ranks (what the per-rank autograd differentiates) is
    # the true loss, as in JAX
    tp_div = dist.tp if dist.model_axis is not None else 1
    if cfg.task == "node_class":
        labels = graph["labels"].long()
        logp = torch.log_softmax(out.float(), dim=-1)
        ce = -torch.gather(logp, -1, labels[:, None])[:, 0]
        den = torch.clamp(torch.sum(nmask), min=1.0)
        loss = torch.sum(ce * nmask) / den
        acc = torch.sum((torch.argmax(out, -1) == labels) * nmask) / den
        return loss / tp_div, {"acc": acc, "ce": loss}
    # graph regression: segment-sum readout over graph ids
    gid = graph["graph_ids"]
    targets = graph["targets"]
    n_graphs = targets.shape[0]
    energy = _segment_sum(out[:, 0] * nmask, gid, n_graphs)
    err = energy - targets
    gmask = graph.get("graph_mask")
    if gmask is None:
        gmask = torch.ones((n_graphs,), dtype=torch.float32,
                           device=targets.device)
    loss = torch.sum(err * err * gmask) / torch.clamp(torch.sum(gmask), min=1.0)
    return loss / tp_div, {"mse": loss}
