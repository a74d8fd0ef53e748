"""Deterministic synthetic data (numpy, shared bit for bit with ``repro``)."""
