"""The program-span reader on a made-up trace: device time by the
innermost ``ps.*`` span open at each launch (from any thread) and by
round, host self time on each thread, and the device's idle time split by
the spans open on the host over each part of a gap; then the span report
on each cell's small version on the CPU."""
import pytest

from portbench.tests.small import CELLS
from portbench.yardstick import spans, trace


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# two rounds of a step: forward (a collection inside it), backward (its
# kernels launched from autograd's thread 7), then the exchange
EVENTS = [
    _x("user_annotation", "pb.window", 0, 1000),
    _x("user_annotation", "pb.round", 0, 500),
    _x("user_annotation", "pb.round", 500, 500),
    _x("user_annotation", "pb.fwd_bwd", 0, 400),  # the benchmark's: ignored
    _x("user_annotation", "ps.forward", 0, 200),
    _x("user_annotation", "ps.gc", 100, 60),
    _x("user_annotation", "ps.backward", 200, 200),
    _x("user_annotation", "ps.exchange", 420, 60),
    _x("user_annotation", "ps.shard_apply", 430, 20),
    _x("user_annotation", "ps.forward", 500, 200),
    _x("user_annotation", "ps.backward", 700, 250),
    _x("user_annotation", "unrelated", 20, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 180, 2, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 250, 2, corr=3, tid=7),
    _x("cuda_runtime", "cudaLaunchKernel", 435, 2, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 490, 2, corr=5),
    _x("cuda_runtime", "cudaLaunchKernel", 510, 2, corr=6),
    _x("cuda_runtime", "cudaLaunchKernel", 720, 2, corr=7, tid=7),
    _x("kernel", "a", 20, 60, corr=1),      # ps.forward, round 0
    _x("kernel", "b", 190, 20, corr=2),     # ps.forward
    _x("kernel", "c", 260, 100, corr=3),    # ps.backward (thread 7)
    _x("kernel", "upd", 440, 10, corr=4),   # ps.shard_apply
    _x("gpu_memcpy", "copy", 492, 4, corr=5),  # outside any span
    _x("kernel", "d", 520, 100, corr=6),    # ps.forward, round 1
    _x("kernel", "e", 730, 200, corr=7),    # ps.backward
    _x("kernel", "stray", 940, 10, corr=99),  # no launch in the trace
]


def test_device_time_by_innermost_span_and_round():
    s = spans.summarize(EVENTS)
    assert s["span_us"] == {"ps.forward": 180.0, "ps.backward": 300.0,
                            "ps.shard_apply": 10.0, trace.OUTSIDE: 4.0,
                            trace.UNATTRIBUTED: 10.0}
    assert s["rounds_us"] == [
        {"ps.forward": 80.0, "ps.backward": 100.0, "ps.shard_apply": 10.0,
         trace.OUTSIDE: 4.0},
        {"ps.forward": 100.0, "ps.backward": 200.0}]


def test_idle_split_by_the_spans_open_over_each_gap():
    s = spans.summarize(EVENTS)
    # gaps: 80-190 (forward 80-100 and 160-190, gc 100-160), 210-260
    # (backward), 360-440 (backward to 400, outside to 420, exchange to
    # 430, shard_apply), 450-492 (exchange to 480, outside), 496-520
    # (outside to 500, forward), 620-730 (forward to 700, backward),
    # 930-940 (backward)
    assert s["idle_us"] == pytest.approx({
        "ps.forward": 20 + 30 + 20 + 80, "ps.gc": 60.0,
        "ps.backward": 50 + 40 + 30 + 10, trace.OUTSIDE: 20 + 12 + 4,
        "ps.exchange": 10 + 30, "ps.shard_apply": 10.0})
    assert s["idle_total_us"] == pytest.approx(sum(s["idle_us"].values()))
    # the benchmark's own reader sees the same idle, by another rule
    gaps = trace.summarize(EVENTS)["idle_gaps"]
    assert s["idle_total_us"] == pytest.approx(sum(v for _, v in gaps) * 1e6)
    r0, r1 = s["idle_rounds_us"]
    assert r0 == pytest.approx({"ps.forward": 50.0, "ps.gc": 60.0,
                                "ps.backward": 90.0, trace.OUTSIDE: 36.0,
                                "ps.exchange": 40.0, "ps.shard_apply": 10.0})
    assert r1 == pytest.approx({"ps.forward": 100.0, "ps.backward": 40.0})


def test_host_self_time_on_each_thread():
    s = spans.summarize(EVENTS)
    assert s["host_self_us"] == pytest.approx({
        "ps.forward": 400 - 60, "ps.gc": 60.0, "ps.backward": 450.0,
        "ps.exchange": 60 - 20, "ps.shard_apply": 20.0})


def test_round_ms_and_gaps_by_span():
    s = spans.summarize(EVENTS)
    assert spans.round_ms(s, "ps.forward") == pytest.approx(0.09)
    assert spans.round_ms(s, "ps.backward") == pytest.approx(0.15)
    # gc idles 60 us in round 0 and none in round 1: the median is 30
    assert spans.round_ms(s, "ps.gc", "idle_rounds_us") == pytest.approx(0.03)
    assert spans.round_ms(s, "ps.encode") is None
    top = spans.idle_gaps_by_span(s, top=2)
    assert top == [["ps.forward", pytest.approx(150e-6)],
                   ["ps.backward", pytest.approx(130e-6)]]


def test_a_trace_without_spans_reads_nothing():
    plain = [e for e in EVENTS if not e["name"].startswith("ps.")]
    s = spans.summarize(plain)
    assert set(s["span_us"]) == {trace.OUTSIDE, trace.UNATTRIBUTED}
    assert spans.round_ms(s, "ps.forward") is None
    assert spans.round_ms(s, "ps.forward", "idle_rounds_us") is None
    assert s["host_self_us"] == {}
    device_only = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS]
    s = spans.summarize(device_only)
    assert s["rounds_us"] == [] and s["idle_rounds_us"] == []
    assert spans.round_ms(s, "ps.forward") is None


EXPECTED = {
    "resnet50.phub_k2_f32": {"ps.pull", "ps.unflatten", "ps.worker_grad",
                             "ps.flatten", "ps.push", "ps.aggregate",
                             "ps.shard_apply"},
    "resnet50.phub_k8_int8": {"ps.pull", "ps.unflatten", "ps.worker_grad",
                              "ps.flatten", "ps.push", "ps.encode",
                              "ps.aggregate", "ps.shard_apply"},
    "equiformer-v2.spmd_molecule": {"ps.forward", "ps.backward",
                                    "ps.exchange", "ps.reduce_scatter",
                                    "ps.shard_apply", "ps.all_gather",
                                    "ps.metrics"},
}


@pytest.mark.parametrize("workload", CELLS)
def test_span_report_on_the_small_cell(workload):
    """The report on the CPU: the ranged stretch holds the program's spans
    of the cell's layers, and the counters cover the stretch."""
    from portbench import spanreport

    out = spanreport.report(workload, 2**31 + 11, 2, "cpu", small=True)
    ranged = out["ranged"]
    assert EXPECTED[workload] <= set(ranged["host_self_ms"])
    c = ranged["counters"]
    assert c["gc_collections"] >= 0 and c["gc_ms"] >= 0
    if workload.startswith("equiformer"):
        assert c["exchange_rounds"] == 2
        # world 1: the flat gradient into the reduce-scatter, as many bytes
        # out of the all-gather, whole f32 chunks, each round
        rs = c["collective_bytes.reduce_scatter"]
        assert rs == c["collective_bytes.all_gather"] > 0
        assert c["collective_bytes"] == 2 * rs
        assert rs % (2 * 4 * 1024) == 0
    else:
        assert c["bytes_pushed"] > 0
    assert out["device_only"]["round_ms"] > 0
    assert out["untraced"]["round_ms"] > 0
    assert out["untraced"]["counters"]["gc_ms"] >= 0
