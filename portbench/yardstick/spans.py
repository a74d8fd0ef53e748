"""Reading the program's own spans in a ``torch.profiler`` trace.

The program marks its layers with ``record_function`` ranges named
``ps.<what>`` (``repro_torch.tracing``).  Three views of a traced stretch:

- device time: every device operation is charged to the innermost
  program span open on the host when it was launched, matched by time
  and not by thread (autograd launches the backward's kernels from its
  own thread while the span that called it waits), as ``trace.py``
  charges the benchmark's ``pb.*`` ranges; split by ``pb.round`` where
  the stretch marks rounds;
- host time: each span's self time on its own thread (its length less
  that of the program spans directly inside it);
- idle: each interval in which the device runs nothing, between the
  stretch's first and last operation, split by the innermost program span
  open on the host (any thread) over each part of it.  A part with no
  span open goes to ``outside``.  A gap is not charged to the launch
  that ends it: a collection of the garbage collector ends in the next
  span's first launch.

A device-only profile carries no host ranges, so these views read the
stretch that traces the host's ops too.
"""
from __future__ import annotations

import bisect
import statistics

from portbench.yardstick.trace import (
    DEVICE_CATS,
    LAUNCH_CATS,
    UNATTRIBUTED,
    _innermost,
)

PREFIX = "ps."


def _round_of(rounds: list, ts: float) -> int:
    """Index of the ``pb.round`` range holding ``ts``, else -1."""
    i = bisect.bisect_right(rounds, (ts, float("inf"))) - 1
    return i if i >= 0 and ts <= rounds[i][1] else -1


def _host_self(spans: list) -> dict:
    """Self µs by span name: each span less its direct children on the
    same thread."""
    out: dict = {}
    by_tid: dict = {}
    for start, end, name, tid in spans:
        by_tid.setdefault(tid, []).append((start, -end, name))
    for items in by_tid.values():
        items.sort()
        stack: list = []  # [end, name, self]
        for start, neg_end, name in items:
            end = -neg_end
            while stack and stack[-1][0] < end:  # not inside the top
                _, n, own = stack.pop()
                out[n] = out.get(n, 0.0) + own
            if stack:
                stack[-1][2] -= end - start
            stack.append([end, name, end - start])
        for _, n, own in stack:
            out[n] = out.get(n, 0.0) + own
    return out


def summarize(events: list) -> dict:
    """The program's spans in ``events`` (a chrome trace's events).

    ``span_us``        device µs by innermost program span at the launch
                       (``outside`` where none was open, ``unattributed``
                       where the trace holds no launch);
    ``rounds_us``      the same for each ``pb.round`` range, in order;
    ``host_self_us``   each span's host self µs, over the stretch;
    ``idle_us``        device-idle µs by innermost program span open on
                       the host, over the stretch;
    ``idle_rounds_us`` the same for each ``pb.round`` range;
    ``idle_total_us``  all device-idle µs of the stretch."""
    spans, rounds, launches, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if name.startswith(PREFIX):
                spans.append((ts, ts + dur, name, e.get("tid")))
            elif name == "pb.round":
                rounds.append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((ts, ts + dur, corr))
    ranges = sorted((s, e, n) for s, e, n, _ in spans)
    rounds.sort()
    device.sort(key=lambda d: (d[0], d[1]))

    span_us: dict = {}
    rounds_us = [{} for _ in rounds]
    for start, end, corr in device:
        host = launches.get(corr)
        where, i = UNATTRIBUTED, -1
        if host is not None:
            where = _innermost(ranges, host)
            i = _round_of(rounds, host)
        span_us[where] = span_us.get(where, 0.0) + (end - start)
        if i >= 0:
            rounds_us[i][where] = rounds_us[i].get(where, 0.0) + (end - start)

    # the device's idle intervals, cut wherever a span or a round starts
    # or ends, each part charged by its midpoint
    cuts = sorted({t for s, e, _ in ranges for t in (s, e)}
                  | {t for s, e in rounds for t in (s, e)})
    idle_us: dict = {}
    idle_rounds_us = [{} for _ in rounds]
    total = 0.0
    reach = None
    for start, end, _ in device:
        if reach is not None and start > reach:
            total += start - reach
            lo = bisect.bisect_right(cuts, reach)
            hi = bisect.bisect_left(cuts, start)
            points = [reach, *cuts[lo:hi], start]
            for a, b in zip(points, points[1:]):
                if b <= a:
                    continue
                mid = (a + b) / 2
                who = _innermost(ranges, mid)
                idle_us[who] = idle_us.get(who, 0.0) + (b - a)
                i = _round_of(rounds, mid)
                if i >= 0:
                    idle_rounds_us[i][who] = (idle_rounds_us[i].get(who, 0.0)
                                              + (b - a))
        reach = end if reach is None else max(reach, end)
    return {"span_us": span_us, "rounds_us": rounds_us,
            "host_self_us": _host_self(spans), "idle_us": idle_us,
            "idle_rounds_us": idle_rounds_us, "idle_total_us": total}


def round_ms(summary: dict | None, name: str,
             key: str = "rounds_us") -> float | None:
    """Median ms a round of ``name`` under ``key`` (``rounds_us``: device
    time; ``idle_rounds_us``: idle time), None where the stretch holds
    none of it or marks no rounds."""
    if not summary or not summary[key]:
        return None
    total = "span_us" if key == "rounds_us" else "idle_us"
    if not summary[total].get(name):
        return None
    return statistics.median(r.get(name, 0.0) for r in summary[key]) / 1e3


def idle_gaps_by_span(summary: dict, top: int = 10) -> list:
    """The ``top`` largest idle shares by span, ``[name, seconds]``."""
    idle = sorted(summary["idle_us"].items(), key=lambda kv: -kv[1])[:top]
    return [[n, us / 1e6] for n, us in idle]
