"""The trace reader on a made-up trace: device time charged to the
innermost range open at each launch (from any thread) and split by
round, busy time as the union of device intervals, idle gaps by the
range that ends them, and a launch missing from the trace charged apart;
and the metric readers on what it returns."""
import pytest

from portbench.metrics import (
    device_idle_share,
    exchange_ms,
    fwd_bwd_ms,
    mfu,
    ps_update_ms,
    ps_update_roofline,
    wire_bytes_per_sample,
)
from portbench.yardstick import trace


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "pb.window", 0, 1000),
    _x("user_annotation", "pb.round", 5, 475),
    _x("user_annotation", "pb.round", 490, 400),
    _x("user_annotation", "pb.fwd_bwd", 10, 400),
    _x("user_annotation", "pb.exchange", 500, 300),
    _x("user_annotation", "pb.ps_update", 600, 100),
    _x("user_annotation", "unrelated", 20, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=2, tid=7),  # autograd
    _x("cuda_runtime", "cudaMemcpyAsync", 550, 2, corr=3),
    _x("cuda_driver", "cuLaunchKernel", 650, 2, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 900, 2, corr=5),
    _x("kernel", "conv", 30, 100, corr=1),
    _x("kernel", "conv", 320, 50, corr=2),
    _x("gpu_memcpy", "copy", 560, 20, corr=3),
    _x("kernel", "update", 660, 10, corr=4),
    _x("kernel", "stray", 700, 40, corr=99),
    _x("kernel", "tail", 905, 30, corr=5),
    _x("kernel", "late", 1500, 30, corr=5),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 20},
]


def test_device_time_by_innermost_range_and_round():
    s = trace.summarize(EVENTS)
    assert s["range_us"] == {"pb.fwd_bwd": 150.0, "pb.exchange": 20.0,
                             "pb.ps_update": 10.0,
                             trace.UNATTRIBUTED: 40.0, trace.OUTSIDE: 60.0}
    assert s["rounds_us"] == [{"pb.fwd_bwd": 150.0},
                              {"pb.exchange": 20.0, "pb.ps_update": 10.0}]
    # every device operation of the profile counts, the late one too
    assert s["busy_us"] == 280.0 and s["window_us"] == 1000.0
    assert s["device_ops"][0] == ["conv", 150e-6]


def test_idle_gaps_by_the_range_that_ends_them():
    gaps = dict(trace.summarize(EVENTS)["idle_gaps"])
    # from the first operation on: 130-320 ends in a fwd_bwd launch;
    # 370-560 in the exchange's copy; 580-660 in the update; 670-700 in
    # the stray; 740-905 and 935-1500 outside any range
    assert gaps == pytest.approx({
        "pb.fwd_bwd": 190e-6, "pb.exchange": 190e-6, "pb.ps_update": 80e-6,
        trace.UNATTRIBUTED: 30e-6, trace.OUTSIDE: 730e-6})


def test_a_trace_without_host_ranges_spans_its_device_work():
    device_only = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS]
    s = trace.summarize(device_only)
    assert s["window_us"] is None and s["rounds_us"] == []
    assert s["range_us"] == {trace.UNATTRIBUTED: 280.0}
    assert s["busy_us"] == 280.0


def test_readers():
    layers = dict(trace.summarize(EVENTS), rounds=2)
    # the median of each range over the rounds: [150, 0], [0, 20], [0, 10]
    busy = {"busy_us": 750.0, "window_us": 1000.0, "round_ms": [10.0, 30.0]}
    ctx = {"layers": layers, "busy": busy, "rounds": 4, "samples": 64,
           "flops_per_round": 6.7e11, "update_bytes": 3.35e6,
           "counters": {"bytes_pushed": 100, "bytes_pulled": 28}}
    assert fwd_bwd_ms.read(ctx) == pytest.approx(0.075)
    assert exchange_ms.read(ctx) == pytest.approx(0.010)
    assert ps_update_ms.read(ctx) == pytest.approx(0.005)
    # 3.35e6 bytes at 3.35e12 B/s is 1 us against 5 us
    assert ps_update_roofline.read(ctx) == pytest.approx(20.0)
    assert mfu.read(ctx) == pytest.approx(50.0)  # 6.7e11 in 20 ms
    assert device_idle_share.read(ctx) == pytest.approx(25.0)
    assert wire_bytes_per_sample.read(ctx) == 2.0


def test_readers_find_nothing_without_a_device():
    ctx = {"layers": {"range_us": {}, "rounds_us": [{}, {}], "rounds": 2},
           "busy": {"busy_us": 0.0, "window_us": 1000.0, "round_ms": [1.0]},
           "rounds": 2, "samples": 4, "flops_per_round": 1.0,
           "update_bytes": 1, "counters": {}}
    for reader in (fwd_bwd_ms, exchange_ms, ps_update_ms, ps_update_roofline,
                   mfu, device_idle_share, wire_bytes_per_sample):
        assert reader.read(ctx) is None
