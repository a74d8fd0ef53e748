"""Share of the traced window in which no operation runs on the device:
its stretch that traces device activity alone, so that the profiler's
host overhead does not widen the gaps."""


def read(ctx: dict) -> float | None:
    busy = ctx.get("busy")
    if not busy or busy["busy_us"] <= 0 or busy["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - busy["busy_us"] / busy["window_us"])
