"""Host-clock spans of the serving engine, one record for the process.

The :class:`~repro_torch.obs.trace.Tracer` keeps the engine's *simulated*
clock and hangs its events off incidents; this record keeps the *host's*
time of the engine's own phases (``InferenceEngine`` opens and closes
every span), so a reader can tell where a step's milliseconds go and what
the host was doing while the device sat idle.  The names::

    request.queue    ``submit`` -> admission (request id; outside the nesting)
    engine.admit     the whole admission loop
      engine.prefill   one prefill (request id)
        prefill.enqueue  ``Model.prefill``, its read-back of ``pos``
        prefill.wait     the first token's copy to the host
    engine.step      the whole decode step
      step.enqueue     the tokens' copy to the device and the step issued:
                       on the card one CUDA graph's replay (at the first
                       step its eager warm-up and capture), elsewhere
                       ``Model.decode_step`` run eagerly
        step.replay      the graph's replay alone
      step.wait        the next tokens' copy to the host, which waits for
                       the device to finish the step
    engine.flush     the step's events into the sink, the DPU's advance

Times are ``time.perf_counter_ns()``.  Recording is always on and draws
nothing from the control loop: a span is two clock reads and one tuple
appended to a ring of :data:`CAPACITY` closed spans, which keeps the
newest and counts what it drops.  The record emits nothing into
``torch.profiler``: an annotation costs ~12 us a use even with no
profiler running, and would mix with the annotations of a profiled
caller; :func:`to_profiler_ns` maps a span onto the profiler's clock
instead.
One thread records at a time (the engine's loop).
"""

from __future__ import annotations

from collections import deque
from itertools import count
from time import perf_counter_ns, time_ns
from typing import NamedTuple

#: closed spans the ring holds; older ones are dropped, and counted
CAPACITY = 1 << 16


class HostSpan(NamedTuple):
    index: int       # order of opening, process-wide
    name: str
    start: int       # time.perf_counter_ns()
    end: int
    parent: int      # index of the span it nests in, -1 for none
    rid: int         # request id, -1 for none
    node: int        # the engine's node


class HostSpans:
    """A bounded ring of closed host-clock spans, oldest first.  ``open``
    nests a span in the innermost open one and ``close`` ends it;
    ``begin`` opens a span outside the nesting (a request's wait, which
    outlives its iteration) and ``end`` ends that.  A handle is
    ``(index, name, start, parent, rid, node)``."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._index = count()
        self._closed = 0          # spans stored, ever
        self._current = -1        # index of the innermost open span

    def open(self, name: str, rid: int = -1, node: int = 0) -> tuple:
        i = next(self._index)
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        h = (i, name, perf_counter_ns(), self._current, rid, node)
        self._current = i
        return h

    def close(self, h: tuple) -> None:
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        end = perf_counter_ns()
        self._current = h[3]
        self._closed += 1
        self._ring.append((h[0], h[1], h[2], end, h[3], h[4], h[5]))

    def begin(self, name: str, rid: int = -1, node: int = 0) -> tuple:
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        return (next(self._index), name, perf_counter_ns(), -1, rid, node)

    def end(self, h: tuple) -> None:
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        end = perf_counter_ns()
        self._closed += 1
        self._ring.append((h[0], h[1], h[2], end, h[3], h[4], h[5]))

    @property
    def dropped(self) -> int:
        """Closed spans the ring no longer holds."""
        return max(self._closed - self.capacity, 0)

    def within(self, t0: int, t1: int) -> list[HostSpan] | None:
        """The spans that start at or after ``t0`` and end at or before
        ``t1`` (``perf_counter_ns``), by start; None, never a part, where
        the ring may have dropped one: spans are stored as they end, so it
        holds every span that ended after its oldest one did."""
        if self.dropped and t0 <= self._ring[0][3]:
            return None
        out = [HostSpan._make(s) for s in self._ring
               if s[2] >= t0 and s[3] <= t1]
        out.sort(key=lambda s: (s.start, s.index))
        return out


#: the process's record: every engine writes to it, readers outlive them
HOST_SPANS = HostSpans()


def to_profiler_ns(t: int) -> int:
    """``t`` (``perf_counter_ns``) on ``torch.profiler``'s clock, which
    stamps its events in nanoseconds of the wall clock (``time.time_ns()``),
    as a ``record_function`` around the same body shows on the CPU and on
    the card.  The offset is read now, so a slewed wall clock moves it
    only between calls."""
    # repro-lint: allow(wall-clock): clock mapping, observe-only
    return t + time_ns() - perf_counter_ns()
