"""The step's share of the H100's f32 peak: the model FLOPs of a round
(the reference's forward and backward counted once on meta tensors,
``yardstick.costs.step_flops``) over the mean round time (CUDA events at
the round boundaries) of the traced window's stretch that traces device
activity alone, at 67 TFLOP/s."""
import statistics

from portbench.yardstick.costs import PEAK_F32_FLOPS


def read(ctx: dict) -> float | None:
    busy = ctx.get("busy")
    if not busy or busy["busy_us"] <= 0 or not busy["round_ms"]:
        return None
    round_s = statistics.fmean(busy["round_ms"]) / 1e3
    return 100.0 * ctx["flops_per_round"] / round_s / PEAK_F32_FLOPS
