"""Entry points of the port (torch counterpart of ``repro.launch``)."""
