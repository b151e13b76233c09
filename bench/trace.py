"""Reduce a ``torch.profiler`` trace, in memory, to what the readers need.

The profiler's events are read once from its Kineto results (no timeline
is written out): the device's operations (kernels, copies, sets) as
intervals, the host's annotations (the loop's phase spans and the traced
window), and the host-side runtime calls (launches, copies, sets) that each
operation's correlation id points back to."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: tuple[int, int]                       # ns, the traced window
    ops: list = field(default_factory=list)   # (name, kind, start, end, corr)
    spans: list = field(default_factory=list)    # (name, start, end)
    launches: dict = field(default_factory=dict)  # correlation id -> start

    def launched_in(self, name: str) -> int:
        """Kernels whose launch on the host lies inside a ``name`` span."""
        ranges = sorted((s, e) for n, s, e in self.spans if n == name)
        starts = [s for s, _ in ranges]
        count = 0
        for op in self.kernels():
            t = self.launches.get(op[4])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            count += i >= 0 and t < ranges[i][1]
        return count

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self):
        return [o for o in self.ops if o[1] == "kernel"]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device (the union of their intervals)."""
        total, end = 0, None
        for _, _, s, e, _ in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def device_s_by_span(self) -> dict[str, float]:
        """Device seconds of the window's operations, summed by the loop
        span whose host call issued each (``loop`` outside every span)."""
        out: dict[str, float] = {}
        for _, _, s, e, corr in self.ops:
            s, e = max(s, self.window[0]), min(e, self.window[1])
            t = self.launches.get(corr)
            if e <= s:
                continue
            span = "loop" if t is None else self.span_at(t)
            out[span] = out.get(span, 0.0) + (e - s) * 1e-9
        return out

    def span_at(self, t: int) -> str:
        """The innermost loop span the host was in at time t (spans nest
        at most two deep: a prefill inside an admission)."""
        if not hasattr(self, "_starts"):
            self.spans.sort(key=lambda sp: sp[1])
            self._starts = [sp[1] for sp in self.spans]
        i = bisect.bisect_right(self._starts, t) - 1
        for name, s, e in reversed(self.spans[max(i - 3, 0):i + 1]):
            if s <= t < e:
                return name
        return "loop"

    def idle_gaps(self) -> list[tuple[str, int]]:
        """Each stretch of the window with nothing on the device, named by
        the span the host was in when the device went idle."""
        gaps, end = [], self.window[0]
        for _, _, s, e, _ in sorted(self.ops, key=lambda o: o[2]):
            if s > end:
                gaps.append((self.span_at(end), s - end))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((self.span_at(end), self.window[1] - end))
        return gaps


def _kind(ev) -> str:
    """The event's Kineto activity type; where this torch's events do not
    give it, worked out from the device, the annotation flag and the
    name."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    note = getattr(ev, "is_user_annotation", lambda: False)()
    name = ev.name()
    if str(ev.device_type()).endswith("CUDA"):
        if note:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if note:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def reduce(prof, window_name: str) -> Trace:
    events = prof.profiler.kineto_results.events()
    win = None
    ops, spans, launches = [], [], {}
    for ev in events:
        kind = _kind(ev)
        if kind not in DEVICE_KINDS and kind != "user_annotation" \
                and kind not in ("cuda_runtime", "cuda_driver"):
            continue
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind in DEVICE_KINDS:
            ops.append((ev.name(), kind, start, end, ev.correlation_id()))
        elif kind == "user_annotation":
            if ev.name() == window_name:
                win = (start, end)
            else:
                spans.append((ev.name(), start, end))
        else:
            launches[ev.correlation_id()] = start
    if win is None:
        raise RuntimeError(f"the trace holds no '{window_name}' annotation")
    return Trace(win, ops, spans, launches)
