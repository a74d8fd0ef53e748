"""Equivariant GNN (EquiformerV2 / eSCN backbone) + graph utilities (torch
counterpart of ``repro.models.gnn``)."""
