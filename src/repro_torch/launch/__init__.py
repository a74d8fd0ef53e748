"""Entry points of the port (torch counterpart of ``repro.launch``): the
mesh over ``torch.distributed``, the per-cell step builders, and the
train and serve drivers."""
