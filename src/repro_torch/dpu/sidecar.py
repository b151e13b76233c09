"""DPUSidecar — the DPU as a first-class asynchronous node.

Composes the whole on-DPU control plane and exposes the same producer-facing
protocol a ``TelemetryPlane`` does, so any event producer (the cluster
simulator, the live serving engine, a ReplicaSet front-end) can be pointed
at a *modeled* DPU instead of an in-process plane:

    host tap --(uplink: delay/jitter/drop/partition)--> ingest guard
      (seq/checksum) --> ingest ring (bounded) --> budget-paced drain
      --> detectors + attribution (TelemetryPlane)
      --> PolicyEngine (arbitration, quarantine) --> CommandBus
      (RTT/acks/backoff retries) --(downlink)--> host actuator

The host drives the loop by calling ``advance(now)`` once per scheduling
round; everything in between is event-time deterministic, so golden
fixtures can pin dpu-mode findings the same way they pin instant-mode ones.

Clock discipline: the detector plane runs on *event time* (batch
timestamps), exactly as in the direct-attach topology — transport delay
shifts *when* the DPU learns about an event, never the event's own
timestamp, so detector math (gap trackers, rate meters) is unchanged.  The
DPU's self-telemetry (ingest-ring occupancy / shed counters, ingest-gap and
command-exhaustion health rows) is stamped with the tap clock — the newest
event timestamp that has arrived — keeping the plane's poll cadence
monotone.

Monitoring-plane chaos (this module's robustness layer):

  crash/restart   — ``crash_at``/``restart_after`` power-cycle the DPU:
                    the ingest ring, detector state, half-confirmed policy
                    decisions, and in-flight commands are lost; the plane's
                    findings/attributions logs (the experiment's record)
                    survive.  A restarted DPU comes back *quarantined*.
  ingest guard    — every tapped batch is stamped with a monotone
                    ``batch_seq`` (and a content checksum when the uplink
                    models corruption); the guard drops replayed/corrupt
                    batches and latches a ``dirty`` flag on sequence gaps
                    that is surfaced as self-telemetry until a host-side
                    ``resync_telemetry`` actuation clears it.
  quarantine      — any fresh ingest gap (blackout end, restart) opens an
                    actuation quarantine on the policy engine: detectors
                    re-warm and re-confirm before any command can fire, so
                    stale pre-gap state never actuates.
  liveness pings  — with ``ping_every > 0`` the bus carries periodic
                    no-op probes; a partitioned command channel exhausts
                    their retries and the exhaustion rate is surfaced as
                    self-telemetry (the ``command_partition`` row's
                    signal), independent of whether the policy engine has
                    anything to say.
  heartbeat       — ``heartbeat_ts`` advances only while the DPU is alive;
                    the host-side ``Watchdog`` reads it out-of-band (the
                    BlueField's dedicated 1GbE management port shares no
                    failure domain with the data-path links).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.detectors import (
    META_DPU_RING,
    META_MON_BUS,
    META_MON_INGEST,
)
from repro_torch.core.events import EventBatch, EventBatchBuilder, EventKind
from repro_torch.core.mitigation import EngineControls
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.dpu.budget import DPUBudget
from repro_torch.dpu.command import PING_ACTION, CommandBus
from repro_torch.dpu.policy import Command, PolicyEngine
from repro_torch.dpu.transport import LinkParams, ModeledLink


@dataclass(frozen=True)
class DPUParams:
    """Everything that distinguishes a modeled DPU from an in-process tap."""

    uplink: LinkParams = field(default_factory=LinkParams)     # host -> DPU
    downlink: LinkParams = field(default_factory=LinkParams)   # DPU -> host
    events_per_s: float = 2e6        # on-DPU detector compute ceiling
    ring_events: int = 65536         # bounded ingest ring (rows)
    ack_timeout: float = 20e-3
    max_retries: int = 3
    stale_after: float = 0.5         # command older than this is invalid
    ack_backoff: float = 2.0         # retry backoff base (exponential)
    ack_timeout_cap: float = 0.25    # backoff ceiling (s)
    # policy-engine knobs (see repro_torch.dpu.policy for the 0.5 floor rationale)
    min_confidence: float = 0.5
    confirmations: int = 2
    cooldown: float = 5.0
    flap_window: float = 2.0
    flap_limit: int = 2
    flap_backoff: float = 2.0
    quorum: int = 3
    quorum_dwell: float = 1.6
    # monitoring-plane chaos / hardening knobs (all off by default; every
    # pre-existing golden fixture runs with these at their defaults)
    crash_at: float = -1.0           # host-clock time the DPU dies (<0: never)
    restart_after: float = 0.0       # dead time before warm restart (0: stays
                                     # down for the rest of the run)
    # post-gap/post-restart actuation holdoff.  Deliberately shorter than
    # the plane's poll interval (0.25 s): detector state resets at the gap,
    # so the first post-gap poll — the only shot a one-shot (latching)
    # detector gets — lands at gap + poll_interval, after the hold expires.
    # A holdoff >= the poll interval would race that poll by milliseconds
    # and silently swallow one-shot rows after every restart.
    quarantine_s: float = 0.2
    ping_every: float = 0.0          # liveness-probe cadence (0: disabled)


class IngestGuard:
    """Sequence/integrity screen between the uplink and the ingest ring.

    Batches stamped with a monotone ``batch_seq`` are checked for replays
    (seq <= newest seen: dropped), gaps (seq skips ahead: counted, and the
    ``dirty`` flag latches until ``resync()``), and — when the sender
    attached a checksum — content corruption (recomputed digest mismatch:
    dropped).  Unstamped batches pass through untouched, so producers that
    bypass the tap keep working.
    """

    def __init__(self) -> None:
        self.last_seq = -1
        self.gaps = 0            # distinct gap episodes
        self.missing = 0         # total sequence numbers skipped
        self.replays = 0         # duplicates/regressions dropped
        self.corrupt = 0         # checksum-mismatch batches dropped
        self.dirty = False       # latched on gap/corruption until resync()
        self.fresh_gap = False   # set by admit() on a NEW gap; caller clears

    def admit(self, batch: EventBatch) -> bool:
        """True if the batch should enter the ring."""
        if batch.checksum is not None \
                and batch.checksum != batch.content_checksum():
            self.corrupt += 1
            self.dirty = True
            self.fresh_gap = True
            return False
        seq = batch.batch_seq
        if seq < 0:
            return True
        if seq <= self.last_seq:
            self.replays += 1
            return False
        if seq > self.last_seq + 1 and self.last_seq >= 0:
            self.gaps += 1
            self.missing += seq - self.last_seq - 1
            self.dirty = True
            self.fresh_gap = True
        self.last_seq = seq
        return True

    def resync(self) -> None:
        """Host-side resync actuation: the stream is declared whole again."""
        self.dirty = False
        self.fresh_gap = False


class DPUSidecar:
    """Asynchronous feedback loop around one TelemetryPlane."""

    def __init__(self, plane: TelemetryPlane,
                 params: DPUParams | None = None,
                 engine: EngineControls | None = None,
                 seed: int = 0,
                 mitigate: bool = True) -> None:
        self.plane = plane
        if plane.controller is not None:
            # actuation belongs to the policy engine on this topology; the
            # inner plane only detects and attributes
            plane.controller = None
        self.params = p = params or DPUParams()
        self.rng = np.random.default_rng(seed ^ 0xD9B0)
        corruptor = (self._corrupt_batch
                     if p.uplink.corrupt_p > 0.0 else None)
        self.uplink = ModeledLink(p.uplink, self.rng, corruptor=corruptor)
        self.budget = DPUBudget(p.events_per_s, p.ring_events)
        self.guard = IngestGuard()
        self.policy: PolicyEngine | None = None
        self.bus: CommandBus | None = None
        if mitigate:
            self.policy = PolicyEngine(
                min_confidence=p.min_confidence,
                confirmations=p.confirmations, cooldown=p.cooldown,
                flap_window=p.flap_window, flap_limit=p.flap_limit,
                flap_backoff=p.flap_backoff, quorum=p.quorum,
                quorum_dwell=p.quorum_dwell)
        if mitigate or p.ping_every > 0.0:
            # the bus exists whenever something needs the channel: the
            # policy engine's commands, or bare liveness pings
            self.bus = CommandBus(
                engine, self.rng, down=p.downlink, ack=p.downlink,
                ack_timeout=p.ack_timeout, max_retries=p.max_retries,
                stale_after=p.stale_after, ack_backoff=p.ack_backoff,
                ack_timeout_cap=p.ack_timeout_cap,
                on_ack=self.policy.on_ack if self.policy else None,
                on_expired=(self.policy.on_expired if self.policy
                            else None))
        self._att_i = 0               # attributions already arbitrated
        self._shed_seen = 0           # sheds already self-reported
        self._stream_clock = 0.0      # newest event ts forwarded to the plane
        # newest event ts that ARRIVED at the DPU (delivered off the uplink,
        # whether or not the budget has processed it yet).  Self-telemetry
        # is stamped with this clock: a fully starved budget that forwards
        # nothing must still report its own saturation — that is the whole
        # point of the row.
        self._tap_clock = 0.0
        self._sample_builder = EventBatchBuilder()
        # chaos state
        self._batch_seq = 0           # tap-side stamp counter
        self.crashed = False
        self._crash_done = False
        self.crash_dropped = 0        # batches floor-dropped while dead
        self.crash_lost_rows = 0      # ring rows lost at crash
        self.restarts = 0
        self._ping_id = 0             # counts down (policy ids count up)
        self._next_ping = 0.0
        self._acked_seen = 0
        self._exhausted_seen = 0
        self._bus_dirty = False       # latched: exhaustion with no ack since
        self.heartbeat_ts = 0.0       # advances only while alive (OOB port)
        # hot-standby leadership (None on a legacy single-DPU deployment:
        # the sidecar then always arbitrates, exactly the pre-lease paths).
        # While a lease is attached but lapsed, detectors stay warm and
        # fresh attributions accumulate in a bounded recall buffer that is
        # replayed into the policy engine on promotion — that replay is
        # what makes hot failover confirm faster than a replay re-warm.
        self.lease = None
        self.recall_s = 1.3
        self._recent_atts: list = []
        # observability (observe-only; None = disabled)
        self.tracer = None
        self.trace_source = ""

    def attach_tracer(self, tracer, source: str,
                      recorder=None) -> None:
        """Thread one shared Tracer through every stage of this sidecar's
        loop (plane findings/attributions, policy decisions, bus
        lifecycle, crash/restart transitions).  Observe-only."""
        self.tracer = tracer
        self.trace_source = source
        self.plane.tracer = tracer
        self.plane.trace_source = source
        if recorder is not None:
            self.plane.recorder = recorder
        if self.policy is not None:
            self.policy.tracer = tracer
            self.policy.trace_source = source
        if self.bus is not None:
            self.bus.tracer = tracer
            self.bus.trace_source = source

    # -- producer-facing plane protocol -----------------------------------

    def observe_batch(self, batch: EventBatch) -> None:
        """Tap: the host hands a batch to the wire, not to the detectors."""
        n = len(batch)
        if n == 0:
            return
        # wire framing: monotone sequence stamp; content checksum only when
        # the uplink actually models corruption (zero-knob path stays free)
        self._batch_seq += 1
        batch.batch_seq = self._batch_seq
        if self.params.uplink.corrupt_p > 0.0:
            batch.checksum = batch.content_checksum()
        # the tap forwards as soon as the producer flushes: send time is the
        # newest timestamp in the batch (batches are built time-sorted)
        self.uplink.send(float(batch.ts[-1]), batch)

    def observe(self, ev) -> None:
        """Per-event compatibility shim (single-row batch on the wire)."""
        b = EventBatchBuilder()
        b.add(ev.ts, int(ev.kind), ev.node, ev.device, ev.flow, ev.size,
              ev.depth, ev.op, ev.group, ev.meta, ev.replica)
        self.observe_batch(b.build(sort=False))

    @staticmethod
    def _corrupt_batch(batch: EventBatch) -> EventBatch:
        """Wire bit-rot: mangle payload columns but keep the sender's frame
        metadata, so the receiver's recomputed digest disagrees with the
        attached checksum and the guard drops the batch."""
        mangled = EventBatch(batch.ts, batch.kind, batch.node, batch.device,
                             batch.flow,
                             np.bitwise_xor(batch.size, np.int64(0x5A5A)),
                             batch.depth, batch.op, batch.group, batch.meta,
                             batch.replica)
        mangled.batch_seq = batch.batch_seq
        mangled.checksum = batch.checksum
        return mangled

    @property
    def findings(self):
        return self.plane.findings

    @property
    def attributions(self):
        return self.plane.attributions

    @property
    def actions(self):
        return self.plane.actions

    @property
    def stats(self):
        return self.plane.stats

    @property
    def controller(self):
        """Non-None while actuation is live (producers use this to keep
        flushing per round so the loop timing stays honest)."""
        return self.policy

    def bind(self, engine: EngineControls) -> None:
        """Point the command bus at the host actuator."""
        if self.bus is not None:
            self.bus.engine = engine

    # -- host-side actuations routed back at the sidecar -------------------

    def resync(self, now: float) -> None:
        """``resync_telemetry`` actuation: the host re-registered the tap;
        the stream is whole from here.  Ends the ingest-dirty latch (and
        with it the blackout self-telemetry)."""
        self.guard.resync()

    # -- leadership (hot-standby pair) -------------------------------------

    def on_lease_granted(self, now: float) -> None:
        """Delivered lease grant: this sidecar now arbitrates.  The recall
        buffer — attributions observed while shadowing — is replayed as
        policy evidence so confirmation counts pick up where the deposed
        leader's would have been, instead of restarting from zero."""
        if self.policy is None:
            return
        for a in self._recent_atts:
            self.policy.observe(a)
        self._recent_atts.clear()

    def drain_recall(self) -> list:
        """Hand the recall buffer to the caller (the watchdog's demotion
        handover): what this sidecar observed while shadowing, for the new
        leader to re-arbitrate."""
        out = self._recent_atts
        self._recent_atts = []
        return out

    # -- chaos: crash / restart -------------------------------------------

    def _crash(self, now: float) -> None:
        self.crashed = True
        self._crash_done = True
        self.crash_lost_rows += self.budget.crash()
        # detector/attribution/dedup state is DPU DRAM — gone
        self.plane.reset_detector_state()
        if self.policy is not None:
            # half-confirmed decisions, cooldown marks, and flap history
            # are gone too; quarantine_until is re-derived at restart
            self.policy.crash_reset(now)
        if self.bus is not None:
            self.bus.drop_outstanding()
        self._recent_atts.clear()     # recall buffer is DPU DRAM too
        if self.tracer is not None:
            self.tracer.on_transition(
                "dpu_crash", now, self.trace_source,
                lost_rows=self.crash_lost_rows)

    def _restart(self, now: float) -> None:
        self.crashed = False
        self.restarts += 1
        # warm restart rejoins the stream mid-flight: the first admitted
        # batch will show a sequence gap, which (re)opens the quarantine;
        # opening it here too covers the no-traffic edge
        if self.policy is not None:
            self.policy.quarantine(now + self.params.quarantine_s)
        self._next_ping = now
        if self.tracer is not None:
            self.tracer.on_transition("dpu_restart", now, self.trace_source,
                                      restarts=self.restarts)

    # -- the DPU's own cycle ----------------------------------------------

    def advance(self, now: float) -> None:
        """One DPU scheduling quantum, driven by the host clock."""
        p = self.params
        if p.crash_at >= 0.0 and not self._crash_done and now >= p.crash_at:
            self._crash(now)
        if (self.crashed and p.restart_after > 0.0
                and now >= p.crash_at + p.restart_after):
            self._restart(now)
        if self.crashed:
            # the wire still delivers; a dead DPU drops frames on the floor
            self.crash_dropped += len(self.uplink.deliver(now))
            return
        for batch in self.uplink.deliver(now):
            if not self.guard.admit(batch):
                continue
            self._tap_clock = max(self._tap_clock, float(batch.ts[-1]))
            self.budget.offer(batch)
        if self.guard.fresh_gap:
            self.guard.fresh_gap = False
            # the stream is discontinuous: detector baselines straddling the
            # hole would read the resumption itself as a cluster pathology
            # (a 300 ms telemetry gap looks exactly like ingress
            # starvation), so the detectors re-warm from post-gap state and
            # the policy engine holds actuation while they do
            self.plane.reset_detector_state()
            if self.policy is not None:
                self.policy.quarantine(now + p.quarantine_s)
        drained = self.budget.drain(now)
        for batch in drained:
            self._stream_clock = max(self._stream_clock,
                                     float(batch.ts[-1]))
            self.plane.observe_batch(batch)
        if (self.bus is not None and p.ping_every > 0.0
                and now >= self._next_ping):
            self._ping_id -= 1
            self.bus.send(Command(cmd_id=self._ping_id, ts=now,
                                  action=PING_ACTION, node=-1,
                                  row_id="", locus="telemetry_plane"),
                          now)
            self._next_ping = now + p.ping_every
        self._self_telemetry()
        if self.policy is not None:
            atts = self.plane.attributions
            fresh = atts[self._att_i:]
            self._att_i = len(atts)
            if self.lease is None or self.lease.holds(now):
                for a in fresh:
                    self.policy.observe(a)
                for cmd in self.policy.decide(now):
                    self.bus.send(cmd, now)
            else:
                # shadow mode: a sidecar without a valid lease must not
                # arbitrate, but it remembers what it saw so promotion
                # can replay the recent evidence window
                self._recent_atts.extend(fresh)
                horizon = now - self.recall_s
                if self._recent_atts and self._recent_atts[0].ts < horizon:
                    self._recent_atts = [a for a in self._recent_atts
                                         if a.ts >= horizon]
        if self.bus is not None:
            recs = self.bus.advance(now)
            if recs:
                self.plane.actions.extend(recs)
                self.plane.agent.stats.actions += len(recs)
        self.heartbeat_ts = now

    def _self_telemetry(self) -> None:
        """Report DPU health into the plane itself: ring occupancy + shed
        deltas (the ``dpu_saturation`` signal), the latched ingest-gap flag
        (``telemetry_blackout``), and command-retry exhaustion
        (``command_partition``)."""
        if self._tap_clock <= 0.0:
            return                     # nothing has arrived yet; clock unset
        b = self._sample_builder
        emitted = False
        shed_delta = self.budget.events_shed - self._shed_seen
        self._shed_seen = self.budget.events_shed
        b.add(self._tap_clock, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
              shed_delta, int(self.budget.occupancy() * 100), -1, -1,
              META_DPU_RING, -1)
        emitted = True
        if self.guard.dirty:
            # latched until resync_telemetry lands: the detector keeps
            # seeing the condition even though actuation is quarantined
            # for the first part of it
            b.add(self._tap_clock, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
                  self.guard.missing + self.guard.corrupt,
                  self.guard.replays, -1, -1, META_MON_INGEST, -1)
        if self.bus is not None:
            s = self.bus.stats
            # only live acks (pings, applies) clear the latch: a late
            # straggler's stale/superseded/fenced nack closes its retry
            # state but proves nothing about current channel health
            if s.live_acked > self._acked_seen:
                self._bus_dirty = False     # channel demonstrably round-trips
            self._acked_seen = s.live_acked
            if s.exhausted > self._exhausted_seen:
                self._bus_dirty = True
            self._exhausted_seen = s.exhausted
            if self._bus_dirty:
                b.add(self._tap_clock, int(EventKind.QUEUE_SAMPLE), -1, -1,
                      -1, s.exhausted, s.retries, -1, -1, META_MON_BUS, -1)
        if emitted:
            self.plane.observe_batch(b.build(sort=False))
            b.clear()

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        out = {
            "uplink": {"sent": self.uplink.sent,
                       "dropped": self.uplink.dropped,
                       "delivered": self.uplink.delivered,
                       "partition_dropped": self.uplink.partition_dropped,
                       "corrupted": self.uplink.corrupted,
                       "duplicated": self.uplink.duplicated},
            "guard": {"gaps": self.guard.gaps,
                      "missing": self.guard.missing,
                      "replays": self.guard.replays,
                      "corrupt": self.guard.corrupt,
                      "dirty": self.guard.dirty},
            "budget": {"offered": self.budget.events_offered,
                       "accepted": self.budget.events_accepted,
                       "shed": self.budget.events_shed,
                       "processed": self.budget.events_processed,
                       "backlog": self.budget.backlog},
            "chaos": {"crashed": self.crashed,
                      "restarts": self.restarts,
                      "crash_dropped": self.crash_dropped,
                      "crash_lost_rows": self.crash_lost_rows},
        }
        if self.bus is not None:
            s = self.bus.stats
            out["commands"] = {
                "sent": s.sent, "retries": s.retries, "acked": s.acked,
                "applied": s.applied, "rejected": s.rejected,
                "stale_dropped": s.stale_dropped,
                "superseded": s.superseded, "expired": s.expired,
                "exhausted": s.exhausted,
            }
        if self.policy is not None:
            out["policy"] = {"issued": len(self.policy.issued),
                             "suppressed": len(self.policy.suppressed),
                             "quarantined": self.policy.quarantined}
        return out
