"""Reading a ``torch.profiler`` trace: device time by the benchmark's
ranges, busy time, idle gaps and the top device operations.

The benchmark marks its calls into each layer with ``record_function``
ranges named ``pb.<layer>`` (``RANGES``), and each round with
``pb.round``.  Every device operation (a
kernel, a copy, a fill) is tied by its correlation id to the host call
that launched it, and is charged to the innermost range open on the host
at that moment.  Ranges are matched by time and not by thread: the
backward's kernels are launched from autograd's own thread while the
range that called it waits.  A device operation with no host launch in
the trace is charged to ``"unattributed"``.
"""
from __future__ import annotations

import bisect
import json

RANGES = ("pb.window", "pb.round", "pb.fwd_bwd", "pb.exchange",
          "pb.ps_update")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"
UNATTRIBUTED = "unattributed"


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _innermost(ranges: list, ts: float) -> str:
    """The name of the innermost of ``ranges`` (start, end, name), sorted
    by start and properly nested, that holds ``ts``."""
    i = bisect.bisect_right(ranges, (ts, float("inf"), "")) - 1
    while i >= 0:
        start, end, name = ranges[i]
        if ts <= end:  # the latest-starting range still open at ts
            return name
        i -= 1
    return OUTSIDE


def summarize(events: list, top: int = 10) -> dict:
    """What the trace says.  The profile spans one stretch that starts and
    ends with the device idle, so every device operation in it is the
    stretch's (none is dropped for a host timestamp that the device clock
    puts a little outside the host's ranges).

    ``range_us``  device µs charged to each range, over the stretch;
    ``rounds_us`` the same for each ``pb.round`` range, in order (empty
                  where the trace marks no rounds);
    ``busy_us``   the union of the device intervals;
    ``window_us`` the ``pb.window`` range's length (None where the trace
                  holds no host ranges);
    ``device_ops`` the ``top`` operations by device time, seconds;
    ``idle_gaps`` device idle time between the first and the last
                  operation, seconds, by the range that launched the
                  operation ending each gap, the ``top`` largest."""
    ranges, rounds, launches, device = [], [], {}, []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name in RANGES:
            if name == "pb.window":
                window = (ts, ts + dur)
            elif name == "pb.round":
                rounds.append((ts, ts + dur, name))
            else:
                ranges.append((ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((ts, ts + dur, name, corr))
    ranges.sort()
    rounds.sort()
    device.sort(key=lambda d: (d[0], d[1]))
    range_us: dict = {}
    rounds_us = [{} for _ in rounds]
    by_name: dict = {}
    owner = []
    for start, end, name, corr in device:
        host = launches.get(corr)
        where, i = UNATTRIBUTED, -1
        if host is not None:
            where = _innermost(ranges, host)
            i = bisect.bisect_right(rounds, (host, float("inf"), "")) - 1
            if i >= 0 and host > rounds[i][1]:
                i = -1
            if where == OUTSIDE and i >= 0:
                where = "pb.round"
        owner.append(where)
        range_us[where] = range_us.get(where, 0.0) + (end - start)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if i >= 0:
            rounds_us[i][where] = rounds_us[i].get(where, 0.0) + (end - start)
    busy, reach, gaps = 0.0, None, {}
    for (start, end, _, _), where in zip(device, owner):
        if reach is not None and start > reach:
            gaps[where] = gaps.get(where, 0.0) + (start - reach)
        busy += end - start if reach is None else max(0.0, end - max(start, reach))
        reach = end if reach is None else max(reach, end)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"range_us": range_us, "rounds_us": rounds_us, "busy_us": busy,
            "window_us": None if window is None else window[1] - window[0],
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}
