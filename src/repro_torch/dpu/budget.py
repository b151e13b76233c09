"""On-DPU compute/ingest budget — a BlueField is not an infinite sink.

The paper's feasibility argument (§4.4) is that detector math fits a DPU's
ARM cores *at line rate*; this module makes the other side of that claim
executable: when event volume exceeds the budget, the DPU must shed load,
and the shedding itself is a self-diagnosable pathology
(``dpu_saturation`` runbook row).

Two resources are modeled:

  * a processing ceiling (``events_per_s``): each ``drain(now)`` call may
    forward at most ``elapsed * events_per_s`` event rows to the detector
    plane; unprocessed rows stay queued,
  * a bounded ingest ring (``ring_events`` rows): ``offer`` accepts the
    prefix of a batch that fits and sheds the rest — exactly what a
    ring-buffer DMA producer does when the consumer falls behind.

Draining is FIFO and may split a batch (``EventBatch.slice``), so a batch
larger than one interval's budget still makes progress.  All arithmetic is
integer/deterministic; the golden fixtures pin the resulting findings.
"""

from __future__ import annotations

from collections import deque

from repro_torch.core.events import EventBatch


class DPUBudget:
    """Events/sec ceiling + bounded ingest ring with shed accounting."""

    def __init__(self, events_per_s: float = 2e6,
                 ring_events: int = 65536) -> None:
        if events_per_s <= 0 or ring_events < 1:
            raise ValueError("budget must be positive")
        self.events_per_s = float(events_per_s)
        self.ring_events = int(ring_events)
        self._ring: deque[EventBatch] = deque()
        self._head_off = 0            # rows of the head batch already drained
        self.backlog = 0              # rows currently queued
        self.events_offered = 0
        self.events_accepted = 0
        self.events_shed = 0
        self.events_processed = 0
        self._last_drain: float | None = None
        self._credit = 0.0      # fractional capacity carried across drains

    # -- producer side --------------------------------------------------

    def offer(self, batch: EventBatch) -> int:
        """Admit up to the ring's free space; returns rows shed."""
        n = len(batch)
        if n == 0:
            return 0
        self.events_offered += n
        free = self.ring_events - self.backlog
        if free <= 0:
            self.events_shed += n
            return n
        if n > free:
            batch = batch.slice(0, free)
            shed = n - free
            n = free
        else:
            shed = 0
        self._ring.append(batch)
        self.backlog += n
        self.events_accepted += n
        self.events_shed += shed
        return shed

    # -- consumer side --------------------------------------------------

    def drain(self, now: float) -> list[EventBatch]:
        """Forward queued batches up to this interval's processing budget."""
        if self._last_drain is None:
            # first call anchors the clock; capacity accrues from here
            self._last_drain = now
            return []
        elapsed = now - self._last_drain
        self._last_drain = now
        if elapsed <= 0 or not self._ring:
            return []
        # carry fractional capacity across calls: a budget smaller than one
        # row per drain interval must still make progress, and int-floor
        # losses must not leak throughput
        self._credit += elapsed * self.events_per_s
        quota = int(self._credit)
        self._credit -= quota
        out: list[EventBatch] = []
        while quota > 0 and self._ring:
            head = self._ring[0]
            remaining = len(head) - self._head_off
            if remaining <= quota:
                out.append(head.slice(self._head_off, len(head))
                           if self._head_off else head)
                self._ring.popleft()
                self._head_off = 0
                quota -= remaining
                self.backlog -= remaining
                self.events_processed += remaining
            else:
                out.append(head.slice(self._head_off,
                                      self._head_off + quota))
                self._head_off += quota
                self.backlog -= quota
                self.events_processed += quota
                quota = 0
        return out

    def occupancy(self) -> float:
        """Ring fill fraction in [0, 1]."""
        return self.backlog / self.ring_events

    # -- chaos ----------------------------------------------------------

    def crash(self) -> int:
        """Power-loss model: the ring is DPU DRAM — everything queued is
        gone.  Cumulative shed/offer counters survive (they are *our*
        experiment accounting, not DPU state); the drain clock and credit
        reset so a restarted DPU accrues no phantom capacity for the time
        it spent dead.  Returns rows lost."""
        lost = self.backlog
        self._ring.clear()
        self._head_off = 0
        self.backlog = 0
        self.events_shed += lost
        self._last_drain = None
        self._credit = 0.0
        return lost
