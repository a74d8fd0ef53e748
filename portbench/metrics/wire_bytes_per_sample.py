"""Bytes on the parameter server's wire (``ServerStats.bytes_pushed``
plus ``bytes_pulled``) in the traced window, per sample."""


def read(ctx: dict) -> float | None:
    c = ctx["counters"]
    if "bytes_pushed" not in c or not ctx["samples"]:
        return None
    return (c["bytes_pushed"] + c["bytes_pulled"]) / ctx["samples"]
