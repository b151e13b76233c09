"""The program's own host-clock spans (``repro_torch.obs.HOST_SPANS``, which
``InferenceEngine`` writes), as the readers in ``metrics/`` take them: the
untraced window's on the host clock, and the traced iterations' mapped
onto the profiler's clock to meet the device's operations.  A program
without the record gives None, and the readers then stay silent."""

from __future__ import annotations

import bisect

ENQUEUE = ("step.enqueue", "prefill.enqueue")
QUEUE = "request.queue"


def source():
    """``(record, to_profiler_ns)`` of the program, or None."""
    try:
        from repro_torch.obs import HOST_SPANS, to_profiler_ns
    except ImportError:
        return None
    return HOST_SPANS, to_profiler_ns


def _ns(t: float) -> int:
    return round(t * 1e9)


def window(ro, since: float | None = None) -> list | None:
    """The spans that lie inside the untraced window (with ``since``, from
    that host time to the window's close)."""
    src = source()
    if src is None:
        return None
    t0 = ro.t_open if since is None else since
    return src[0].within(_ns(t0), _ns(ro.t_close))


def mean_ms(ro, name: str) -> float | None:
    """Mean length of the window's ``name`` spans, in ms."""
    ns = [s.end - s.start for s in window(ro) or () if s.name == name]
    return sum(ns) / len(ns) * 1e-6 if ns else None


def traced(ro) -> list | None:
    """The traced iterations' spans, their times on the profiler's clock;
    None without a trace or without spans."""
    src = source()
    if ro.trace is None or not ro.traced or src is None:
        return None
    record, to_profiler_ns = src
    spans = record.within(_ns(ro.traced[0].t0), _ns(ro.traced[-1].t1))
    if not spans:
        return None
    shift = to_profiler_ns(0)
    return [s._replace(start=s.start + shift, end=s.end + shift)
            for s in spans]


def union(ranges) -> list[tuple[int, int]]:
    """Disjoint ranges covering the same time as ``ranges``, in order."""
    out: list[list[int]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> int:
    """Time that two lists of disjoint ordered ranges share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(e - s, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> list[tuple[int, int]]:
    """The traced window's stretches with nothing on the device."""
    w0, w1 = trace.window
    gaps, end = [], w0
    for _, _, s, e, _ in sorted(trace.ops, key=lambda o: o[2]):
        if min(s, w1) > end:
            gaps.append((end, min(s, w1)))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def idle_pct(ro, inside) -> float | None:
    """Share of the traced window's idle time during which the host was
    inside a span that ``inside`` accepts, in percent."""
    spans = traced(ro)
    if spans is None:
        return None
    gaps = idle(ro.trace)
    total = sum(e - s for s, e in gaps)
    if total <= 0:
        return None
    hit = union((s.start, s.end) for s in spans if inside(s))
    return overlap(gaps, hit) / total * 100


def device_s_launched_in(trace, ranges) -> float:
    """Device seconds, inside the traced window, of the operations whose
    launch on the host lies in one of the disjoint ``ranges``."""
    ranges = union(ranges)
    starts = [s for s, _ in ranges]
    w0, w1 = trace.window
    total = 0
    for _, _, s, e, corr in trace.ops:
        t = trace.launches.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ranges[i][1]:
            total += max(min(e, w1) - max(s, w0), 0)
    return total * 1e-9
