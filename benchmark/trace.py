"""Reduction of a `torch.profiler` session to what the per-layer metrics read.

`collect` takes the profiler's events: the device's (kernels, copies,
sets) as (name, start, end) intervals and the host's `record_function`
spans of the benchmark (`bench.*`), in microseconds on one clock.
`reduce` then clips the device intervals to the traced window (the span
`bench.window`), takes their union (busy seconds), the device time by
operation name, and the idle gaps between device intervals, each named by
the benchmark span and the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect

WINDOW_SPAN = "bench.window"


def collect(prof) -> dict:
    """{'device': [(name, start_us, end_us)], 'host': [(name, start_us,
    end_us)]} from a finished profiler session."""
    device, host = [], []
    for e in prof.events():
        kind = getattr(getattr(e, "device_type", None), "name", "CPU")
        tr = e.time_range
        if kind == "CUDA":
            # a `record_function` span also shows on the device's timeline
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench."):
                device.append((e.name, float(tr.start), float(tr.end)))
        elif kind == "CPU":
            host.append((e.name, float(tr.start), float(tr.end)))
    return {"device": device, "host": host}


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: dict, top: int = 10) -> dict | None:
    """{'window_s', 'busy_s', 'by_name' {name: seconds}, 'device_ops'
    [[name, s]], 'idle_gaps' [[name, s]]}, or None when the window span or
    any device interval is missing."""
    spans = [h for h in events["host"] if h[0] == WINDOW_SPAN]
    if not spans:
        return None
    w0, w1 = spans[0][1], spans[0][2]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in events["device"] if e > w0 and s < w1]
    if not dev:
        return None
    busy = _union([(s, e) for _, s, e in dev])
    by_name: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((h for h in events["host"] if h[0] != WINDOW_SPAN), key=lambda h: h[1])
    starts = [h[1] for h in host]

    def doing(t: float) -> str:
        bench, inner = "", ""
        for name, s, e in host[:bisect.bisect_right(starts, t)]:
            if s <= t <= e:
                if name.startswith("bench."):
                    bench = name
                elif not inner or s >= inner[1]:
                    inner = (name, s)
        return " / ".join(x for x in (bench, inner[0] if inner else "") if x) or "host idle"

    named: dict = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top * 5]:
        key = doing((s + e) / 2)
        named[key] = named.get(key, 0.0) + (e - s) * 1e-6
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        by_name=by_name,
        device_ops=[[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, t] for n, t in sorted(named.items(), key=lambda kv: -kv[1])[:top]],
    )


def kernel_seconds(by_name: dict, needles: tuple) -> float:
    """Device seconds of the operations whose name contains any needle."""
    return sum(t for n, t in by_name.items() if any(k in n for k in needles))
