"""Recsys models over PS-sharded embeddings (torch counterpart of
``repro.models.recsys``): DLRM, AutoInt, DIEN and xDeepFM, with the
model-axis specs, grad-sync maps and lookups of the SPMD path."""
