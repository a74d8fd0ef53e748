"""Device-busy ms a round inside the workers' forward and backward
(``pb.fwd_bwd``), the worker-compute layer."""
from portbench.metrics._shared import range_ms_per_round


def read(ctx: dict) -> float | None:
    return range_ms_per_round(ctx, "pb.fwd_bwd")
