"""Models (torch counterpart of ``repro.models``): the dense transformer and DLRM."""
