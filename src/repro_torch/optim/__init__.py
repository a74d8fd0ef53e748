"""Server-side optimizers as flat update rules (torch counterpart of
``repro.optim``)."""
