"""Architecture configs (torch counterpart of ``repro.configs``)."""
