"""Recsys models over PS-sharded embeddings (torch counterpart of
``repro.models.recsys``): DLRM so far."""
