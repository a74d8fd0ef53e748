"""Device-busy ms a round inside the exchange (``pb.exchange``: pull,
push and the codec, flatten and unflatten, ``device_update``), less the
server update's kernels, which are charged to ``pb.ps_update``."""
from portbench.metrics._shared import range_ms_per_round


def read(ctx: dict) -> float | None:
    return range_ms_per_round(ctx, "pb.exchange")
