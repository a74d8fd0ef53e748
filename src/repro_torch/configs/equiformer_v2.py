"""equiformer-v2 [arXiv:2306.12059]: 12L d_hidden=128 l_max=6 m_max=2 8H,
SO(2)-eSCN equivariant graph attention.  Four graph shape regimes (copy of
``repro/configs/equiformer_v2.py`` with torch dtypes)."""
import torch

from repro_torch.configs.registry import ArchDef, ShapeCell
from repro_torch.models.gnn.equiformer_v2 import EquiformerConfig

CONFIG = EquiformerConfig(
    name="equiformer-v2",
    n_layers=12,
    channels=128,
    l_max=6,
    m_max=2,
    n_heads=8,
    n_rbf=32,
    d_in=1433,  # overridden per shape cell (see launch/steps.py)
    n_out=7,
    task="node_class",
    dtype=torch.float32,
    param_dtype=torch.float32,
)

SMOKE = EquiformerConfig(
    name="equiformer-v2-smoke",
    n_layers=2,
    channels=16,
    l_max=2,
    m_max=1,
    n_heads=4,
    n_rbf=8,
    d_in=12,
    n_out=5,
    task="node_class",
)

CELLS = (
    # cora-like full batch
    ShapeCell("full_graph_sm", "graph_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    # reddit-scale sampled training: per-worker independent subgraphs
    ShapeCell("minibatch_lg", "graph_minibatch",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602, "n_classes": 41,
               "pad_nodes": 180224, "pad_edges": 180224}),
    # ogbn-products full batch, nodes sharded over workers
    ShapeCell("ogb_products", "graph_full_large",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    # batched small molecules, graph-level regression
    ShapeCell("molecule", "graph_molecule",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "n_species": 16}),
)

ARCH = ArchDef(
    arch_id="equiformer-v2",
    family="gnn",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=CELLS,
    notes="channels TP over model axis (psum_scatter per mixing linear); "
    "Wigner/SH featurization host-side; synthetic 3-D coords for "
    "non-geometric datasets (cora/ogbn/reddit)",
)
