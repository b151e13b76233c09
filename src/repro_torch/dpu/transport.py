"""Modeled message transport between host and DPU.

The paper places the DPU *on the network path* — telemetry reaches it over
a real link and mitigation commands travel back over the same fabric the
inference traffic shares.  ``ModeledLink`` is that wire: a one-way channel
with configurable base delay, bounded uniform jitter, Bernoulli loss, a
scheduled hard-partition window, and (for chaos experiments) Bernoulli
payload corruption and duplication.

Determinism contract: the link draws from the RNG handed to it *only* when
the corresponding knob is nonzero (jitter -> one uniform per send, drop ->
one uniform per send, corrupt/duplicate -> one uniform each per delivered
send).  A zero-knob link therefore consumes no randomness at all, which
keeps the golden scenario fixtures reproducible and keeps the simulator's
own generator stream untouched.  The partition window is a pure clock
comparison — it never touches the RNG either way.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass


@dataclass(frozen=True)
class LinkParams:
    """One-way channel model."""

    delay: float = 1e-3       # base one-way latency (s)
    jitter: float = 0.0       # extra uniform [0, jitter) latency per message
    drop_p: float = 0.0       # Bernoulli loss probability per message
    # scheduled hard partition: 100% loss for [start, start + duration).
    # start < 0 disables the window entirely (the default).
    partition_start: float = -1.0
    partition_duration: float = 0.0
    corrupt_p: float = 0.0    # Bernoulli payload bit-rot per message
    duplicate_p: float = 0.0  # Bernoulli replay (second copy) per message
    # ordered-stream vs datagram semantics.  True (the default) models a
    # TCP / ordered-RDMA flow: a message never overtakes its predecessor,
    # so a receiver-side sequence anomaly is always real loss or replay.
    # False models idempotent last-writer-wins datagrams (e.g. router-view
    # snapshots), where out-of-order arrival is part of the channel.
    ordered: bool = True


class ModeledLink:
    """Delay/jitter/loss channel with in-order-by-arrival delivery.

    ``send`` timestamps the message with its arrival time (or drops it);
    ``deliver`` pops every message whose arrival time has passed.  A
    monotone sequence number breaks arrival-time ties so delivery order is
    deterministic and messages never compare against each other.  Arrival
    times are clamped monotone per link (ordered-stream semantics): jitter
    spreads deliveries out but never reorders them.

    ``corruptor`` is an optional callable applied to a payload when the
    corruption coin lands — it returns the mangled payload that arrives
    instead (the original is what the sender *thinks* it sent).  Without a
    corruptor the corrupt draw still burns its coin but the payload passes
    through intact, keeping the RNG stream independent of whether the
    receiver models corruption.
    """

    def __init__(self, params: LinkParams, rng, corruptor=None) -> None:
        self.params = params
        self.rng = rng
        self.corruptor = corruptor
        self._seq = itertools.count()
        self._last_arrival = 0.0
        self._inflight: list[tuple[float, int, object]] = []
        self.sent = 0
        self.dropped = 0
        self.delivered = 0
        self.partition_dropped = 0
        self.corrupted = 0
        self.duplicated = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def partitioned(self, now: float) -> bool:
        """True inside the scheduled partition window.  Pure comparison —
        zero RNG draws whether or not a window is configured."""
        p = self.params
        return (p.partition_start >= 0.0
                and p.partition_start <= now
                < p.partition_start + p.partition_duration)

    def send(self, now: float, payload) -> bool:
        """Enqueue one message; returns False if the wire ate it."""
        p = self.params
        self.sent += 1
        if self.partitioned(now):
            self.partition_dropped += 1
            self.dropped += 1
            return False
        if p.drop_p > 0.0 and self.rng.random() < p.drop_p:
            self.dropped += 1
            return False
        arrival = now + p.delay
        if p.jitter > 0.0:
            arrival += self.rng.random() * p.jitter
        # ordered-stream semantics: the channel is one logical flow (TCP /
        # ordered RDMA QP), so a frame never overtakes its predecessor —
        # neither from a jitter coin nor from a sender whose "send clock"
        # regresses (the telemetry tap stamps sends with each batch's
        # newest event timestamp, and producer flushes are not globally
        # time-monotone under load).  Without the clamp the receiver sees
        # frames re-sorted by payload time while sequence numbers follow
        # tap order, and the ingest guard reads every swap as a sequence
        # gap + replay — continuous detector-reset churn instead of the
        # loss signal it is meant to catch.  Pure arithmetic: the RNG
        # stream is untouched either way.
        if p.ordered:
            arrival = max(arrival, self._last_arrival)
            self._last_arrival = arrival
        if p.corrupt_p > 0.0 and self.rng.random() < p.corrupt_p:
            self.corrupted += 1
            if self.corruptor is not None:
                payload = self.corruptor(payload)
        heapq.heappush(self._inflight, (arrival, next(self._seq), payload))
        if p.duplicate_p > 0.0 and self.rng.random() < p.duplicate_p:
            # a replayed copy arrives strictly later than the original
            self.duplicated += 1
            heapq.heappush(self._inflight,
                           (arrival + p.delay, next(self._seq), payload))
        return True

    def deliver(self, now: float) -> list:
        """Pop every message whose arrival time is <= now."""
        out = []
        q = self._inflight
        while q and q[0][0] <= now:
            out.append(heapq.heappop(q)[2])
        self.delivered += len(out)
        return out


class TapFanout:
    """One producer flush delivered to N independent tap consumers.

    Models the redundant management path of a hot-standby DPU pair: the
    host telemetry tap is mirrored, and each sidecar's uplink is its own
    ``ModeledLink`` with an independent delay/jitter/drop/partition
    schedule.  Fan-out happens *before* frame stamping — every consumer
    after the first receives a fresh frame wrapper (``fork``) around the
    same immutable column arrays, so each leg stamps its own monotone
    ``batch_seq`` and checksum (per-link ingest guards) and one leg's
    in-place frame mutation can never corrupt another leg's view.
    """

    def __init__(self, *consumers) -> None:
        if not consumers:
            raise ValueError("TapFanout needs at least one consumer")
        self.consumers = list(consumers)
        self.forked = 0

    @staticmethod
    def fork(batch):
        """New frame wrapper sharing ``batch``'s column arrays.

        The copy starts unstamped (``batch_seq=-1``, no checksum): frame
        identity is a per-link property, payload columns are shared.
        """
        from ..core.events import EventBatch
        return EventBatch(batch.ts, batch.kind, batch.node, batch.device,
                          batch.flow, batch.size, batch.depth, batch.op,
                          batch.group, batch.meta, batch.replica)

    def observe_batch(self, batch) -> None:
        # secondaries get forks first: the primary's observe_batch stamps
        # seq/checksum on the original frame in place
        for consumer in self.consumers[1:]:
            self.forked += 1
            consumer.observe_batch(self.fork(batch))
        self.consumers[0].observe_batch(batch)
