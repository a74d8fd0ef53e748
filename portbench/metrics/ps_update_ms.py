"""Device ms a round of every operation launched inside the server's
update (``pb.ps_update``: the shards' ``apply`` / ``apply_wire``, the
owned slab's fused update)."""
from portbench.metrics._shared import range_ms_per_round


def read(ctx: dict) -> float | None:
    return range_ms_per_round(ctx, "pb.ps_update")
