"""Host-clock spans of the serving engine, one record for the process.

The :class:`~repro_torch.obs.trace.Tracer` keeps the engine's *simulated*
clock and hangs its events off incidents; this record keeps the *host's*
time of the engine's own phases (``InferenceEngine`` opens and closes
every span), so a reader can tell where a step's milliseconds go and what
the host was doing while the device sat idle.  The names::

    request.queue    ``submit`` -> admission (request id; outside the nesting)
    engine.admit     the whole admission loop
      engine.prefill   one prefill (request id)
        prefill.enqueue  the prompt's copy to the device and the prefill
                         issued: on the card one CUDA graph's replay (at a
                         bucket's first prefill its eager warm-up and
                         capture), elsewhere ``Model.prefill`` run eagerly
          prefill.replay   the graph's replay alone
        prefill.wait     the first token's copy to the host, which waits
                         for the device to finish the prefill (and the
                         slot's cache row copied from it)
    engine.step      the whole decode step
      step.enqueue     the tokens' copy to the device and the step issued:
                       on the card one CUDA graph's replay (at the first
                       step its eager warm-up and capture), elsewhere
                       ``Model.decode_step`` run eagerly
        step.replay      the graph's replay alone
      step.wait        the next tokens' copy to the host, which waits for
                       the device to finish the step
    engine.flush     the step's events into the sink, the DPU's advance

Beside the spans, :data:`EXPERT_STEPS` keeps each decode step's counts of
an MoE model's routing, as the step's read-back brings them to the host
(``InferenceEngine._step``): the pairs its rows routed to the experts held
here and the held experts that took at least one, summed over the MoE
layers.

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


class _Ring:
    """A bounded ring of records, oldest first, each a tuple stored as it
    ends, with its start and end times (``perf_counter_ns``) at positions
    ``START`` and ``END``; it keeps the newest and counts what it drops."""

    START = END = 0

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._stored = 0          # records stored, ever

    def _store(self, record: tuple) -> None:
        self._ring.append(record)
        self._stored += 1

    @property
    def dropped(self) -> int:
        """Records the ring no longer holds."""
        return max(self._stored - self.capacity, 0)

    def _within(self, t0: int, t1: int) -> list | None:
        """The records that start at or after ``t0`` and end at or before
        ``t1``; None, never a part, where the ring may have dropped one:
        it holds every record that ended after its oldest one did."""
        if self.dropped and t0 <= self._ring[0][self.END]:
            return None
        return [r for r in self._ring
                if r[self.START] >= t0 and r[self.END] <= t1]


class HostSpans(_Ring):
    """A bounded ring of closed host-clock spans, oldest first.  ``open``
    nests a span in the innermost open one and ``close`` ends it;
    ``begin`` opens a span outside the nesting (a request's wait, which
    outlives its iteration) and ``end`` ends that.  A handle is
    ``(index, name, start, parent, rid, node)``."""

    START, END = 2, 3

    def __init__(self, capacity: int = CAPACITY) -> None:
        super().__init__(capacity)
        self._index = count()
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
        self._store((h[0], h[1], h[2], end, h[3], h[4], h[5]))

    def begin(self, name: str, rid: int = -1, node: int = 0) -> tuple:
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        return (next(self._index), name, perf_counter_ns(), -1, rid, node)

    def end(self, h: tuple) -> None:
        # repro-lint: allow(wall-clock): host-clock span, observe-only
        end = perf_counter_ns()
        self._store((h[0], h[1], h[2], end, h[3], h[4], h[5]))

    def within(self, t0: int, t1: int) -> list[HostSpan] | None:
        """The spans inside [t0, t1] (``perf_counter_ns``), by start; None
        where the ring may have dropped one."""
        kept = self._within(t0, t1)
        if kept is None:
            return None
        out = [HostSpan._make(s) for s in kept]
        out.sort(key=lambda s: (s.start, s.index))
        return out


#: the process's record: every engine writes to it, readers outlive them
HOST_SPANS = HostSpans()


class ExpertStep(NamedTuple):
    t: int           # time.perf_counter_ns() at booking, after the read-back
    pairs: int       # routed pairs on held experts, every row and MoE layer
    touched: int     # held experts that took a pair, summed over the layers
    held: int        # held experts times MoE layers


class ExpertSteps(_Ring):
    """A bounded ring of :class:`ExpertStep`, oldest first, booked once a
    decode step's counts are on the host; ``within(t0, t1)`` gives the
    steps booked in [t0, t1], or None where the ring may have dropped
    one."""

    def book(self, pairs: int, touched: int, held: int) -> None:
        # repro-lint: allow(wall-clock): host-clock record, observe-only
        self._store(ExpertStep(perf_counter_ns(), pairs, touched, held))

    within = _Ring._within


#: the process's record of MoE decode steps, beside ``HOST_SPANS``
EXPERT_STEPS = ExpertSteps()


def to_profiler_ns(t: int) -> int:
    """``t`` (``perf_counter_ns``) on ``torch.profiler``'s clock, which
    stamps its events in nanoseconds of the wall clock (``time.time_ns()``),
    as a ``record_function`` around the same body shows on the CPU and on
    the card.  The offset is read now, so a slewed wall clock moves it
    only between calls."""
    # repro-lint: allow(wall-clock): clock mapping, observe-only
    return t + time_ns() - perf_counter_ns()
