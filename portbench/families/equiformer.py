"""EquiformerV2's pieces for the drivers: the program's model config and
train step, the reference's loss, the molecule batches, and one batch
on meta tensors for the FLOP count."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import equiformer as ref
from portbench.yardstick.molecules import (
    packed_wigner_size,
    random_molecule_batch,
)


def port_config(cfg: dict, traffic: dict):
    from repro_torch.models.gnn.equiformer_v2 import EquiformerConfig

    return EquiformerConfig(
        name=cfg["name"], n_layers=cfg["n_layers"], channels=cfg["channels"],
        l_max=cfg["l_max"], m_max=cfg["m_max"], n_heads=cfg["n_heads"],
        n_rbf=cfg["n_rbf"], d_in=cfg["d_in"], n_out=cfg["n_out"],
        task="graph_reg")


def param_spec(cfg: dict, traffic: dict) -> dict:
    return ref.param_spec(cfg)


def batches(cfg: dict, traffic: dict, seed: int, device) -> list:
    """One worker's ``batches`` molecule batches, batch ``i`` drawn from
    ``[seed, i]`` on the host and moved to ``device``."""
    out = []
    for i in range(traffic["batches"]):
        b = random_molecule_batch(traffic["batch"], traffic["atoms"],
                                  traffic["edges"], cfg["d_in"],
                                  cfg["l_max"], cfg["n_rbf"],
                                  seed=[seed % 2**64, i])
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in b.items()})
    return [out]


def samples(batch: dict) -> int:
    return batch["targets"].shape[0]


def port_plan(cfg: dict, traffic: dict, mesh, exchange):
    """The program's train step for the molecule cell, as
    ``launch/steps.build_gnn_cell`` builds it for ``launch/train.py``."""
    from repro_torch.configs.registry import ArchDef, ShapeCell
    from repro_torch.launch.steps import build_gnn_cell

    pcfg = port_config(cfg, traffic)
    cell = ShapeCell("molecule", "graph_molecule", {
        "n_nodes": traffic["atoms"], "n_edges": traffic["edges"],
        "batch": traffic["batch"], "n_species": cfg["d_in"]})
    arch = ArchDef(arch_id=cfg["name"], family="gnn", config=pcfg,
                   smoke_config=pcfg, cells=(cell,))
    return build_gnn_cell(arch, cell, mesh, exchange)


def ref_loss(cfg: dict, traffic: dict):
    return lambda params, batch: ref.loss(params, batch, cfg, remat=True)


def meta_loss(cfg: dict, traffic: dict):
    """The loss without recomputation, for the FLOP count."""
    return lambda params, batch: ref.loss(params, batch, cfg, remat=False)


def meta_batch(cfg: dict, traffic: dict) -> dict:
    b = traffic["batch"]
    n, e = b * traffic["atoms"], b * traffic["edges"]

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    return {"node_feat": z((n, cfg["d_in"])),
            "edge_src": z((e,), torch.int64), "edge_dst": z((e,), torch.int64),
            "edge_mask": z((e,)), "node_mask": z((n,)),
            "wigner": z((e, packed_wigner_size(cfg["l_max"]))),
            "rbf": z((e, cfg["n_rbf"])),
            "graph_ids": z((n,), torch.int64), "targets": z((b,)),
            "graph_mask": z((b,))}
