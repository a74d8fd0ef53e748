"""What the per-layer readers share: a range's device time per round."""
from __future__ import annotations

import statistics


def range_ms_per_round(ctx: dict, name: str) -> float | None:
    """Device ms a round charged to the range ``name`` in the traced
    window's stretch with ranges: the median over its rounds, so that a
    record the profiler lost moves no reading.  None where the trace holds
    no such range's work."""
    layers = ctx.get("layers")
    if not layers or not layers["range_us"].get(name):
        return None
    per_round = [r.get(name, 0.0) for r in layers["rounds_us"]]
    return statistics.median(per_round) / 1e3 if per_round else None
