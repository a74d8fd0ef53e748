"""The port's runtime tier (torch counterpart of ``repro.runtime``)."""
