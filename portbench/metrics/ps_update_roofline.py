"""The server update's share of its roofline: the least bytes it needs
(``yardstick.costs.update_bytes``) at the H100's HBM rate, over the
device time of the update (``ps_update_ms``)."""
from portbench.metrics import ps_update_ms
from portbench.yardstick.costs import HBM_BYTES_PER_S


def read(ctx: dict) -> float | None:
    ms = ps_update_ms.read(ctx)
    if not ms:
        return None
    return 100.0 * ctx["update_bytes"] / HBM_BYTES_PER_S / (ms / 1e3)
