"""Host-side watchdog — failover for the monitoring plane itself.

The paper makes the DPU the cluster's nervous system, which makes it a
single point of failure: a crashed DPU (or a partitioned command channel)
leaves every runbook row blind or unactuatable.  ``Watchdog`` is the
host-side answer, modeled after how BlueField deployments actually monitor
their DPUs: the card exposes a dedicated out-of-band 1GbE management port
that shares no failure domain with the data-path links, so the host can
probe DPU liveness (heartbeat cadence, command-bus ack counters) even while
the telemetry uplink or the command downlink is dark.

State machine (single-DPU deployment)::

    NORMAL --(heartbeat silent > silence_timeout,
              or command retries exhaust with zero intervening acks)-->
    FALLBACK --(DPU alive + channel acking for >= failback_hold)--> NORMAL

With a hot standby attached (``standby=`` a second :class:`DPUSidecar`
shadowing the same tap through a :class:`~repro_torch.dpu.transport.TapFanout`),
the watchdog is promoted from "failover to host" to *lease arbiter*
(:class:`~repro_torch.dpu.election.ElectionArbiter` over the same OOB port)::

    NORMAL --(primary dark AND every delivered lease horizon expired
              AND the host-side probe corroborates)--> STANDBY
    NORMAL/STANDBY --(both sidecars dark)--> FALLBACK
    STANDBY --(primary healthy >= failback_hold)--> NORMAL
    FALLBACK --(primary healthy >= failback_hold)--> NORMAL

The standby's detectors are already warm (it shadowed every batch), so a
promotion costs one lease expiry instead of a ``retain_s`` replay, and
the recall buffer it kept while shadowing is replayed into its policy
engine so confirmation counts resume rather than restart.  Split-brain
is fenced, not assumed away: every command carries its issuer's term,
the host actuator rejects stale terms (``split_brain_fenced`` row), and
a new term is only granted once every previously *delivered* lease
horizon has expired — the promotion also requires a host-side
data-path corroboration (ack-channel activity) so a mere OOB partition
with a healthy, actuating primary never elects a second leader.

In FALLBACK the watchdog runs a *degraded* host-side loop: a standby
``TelemetryPlane`` (warmed by replaying the last ``retain_s`` seconds of
tapped batches, then fed live) drives a conservative controller — higher
confidence floor, more confirmations, no cluster-scoped quorum escalation
(the host sees one vantage; cluster-wide actions need the DPU's).  Failback
is hysteretic: the DPU must look healthy for ``failback_hold`` before the
watchdog stands down, and the handover drops half-confirmed policy state so
both controllers never compose a confirmation chain.  The handover back is
also a *state transfer*, in two parts.  First, the returning DPU's plane is
warm-started: its retained tap window is replayed with logging suppressed
(``TelemetryPlane.warm_start``), because a DPU that re-warmed only on
fault-era traffic would calibrate its baselines to the fault — the
pathology reads as normal and rate/peak-latch rows never fire again.
Second, the standby's *evidence* is handed over: attributions observed
during the dark window that the conservative fallback declined to act on
are re-staged through the returning DPU's own arbitration (minus the mon
rows — the DPU's own obituary — and minus anything the fallback already
applied), delivered only once the restart quarantine has expired so a
single-copy handover is never swallowed by a racing hold.

The watchdog wraps a :class:`DPUSidecar` and speaks the same plane
protocol, so ``run_scenario`` can swap it in transparently; its
``findings`` / ``attributions`` / ``actions`` views merge the sidecar's
plane with the standby's (the experiment record spans both).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.detectors import (
    META_MON_BUS,
    META_MON_FENCE,
    META_MON_HEARTBEAT,
    META_MON_RETAIN,
    META_MON_STANDBY,
)
from repro_torch.core.events import EventBatch, EventBatchBuilder, EventKind
from repro_torch.core.mitigation import EngineControls, MitigationController
from repro_torch.core.runbooks import BY_ID, DEFAULT_TABLES
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.dpu.election import ElectionArbiter, LeaseParams
from repro_torch.dpu.sidecar import DPUSidecar
from repro_torch.dpu.transport import TapFanout


@dataclass(frozen=True)
class WatchdogParams:
    """Host-side liveness supervision + degraded-mode policy knobs."""

    silence_timeout: float = 0.08    # heartbeat silence before failover (s)
    probe_every: float = 0.02        # OOB liveness-probe cadence (s)
    failback_hold: float = 0.2       # healthy time required before failback
    # tapped-batch replay window on failover.  Long enough that the replay
    # usually spans pre-incident traffic: the standby's detectors need a
    # healthy baseline to judge the fault era against, and rate-latch rows
    # (e.g. the HBM cliff) are undetectable from fault-era history alone
    retain_s: float = 1.2
    # hard cap on retained batches: ``retain_s`` alone prunes by payload
    # timestamp, so a producer that flushes faster than its event clock
    # advances (many small batches per simulated second) would grow the
    # window without bound.  The cap bounds watchdog memory outright.
    retain_max: int = 4096
    exhaust_min: int = 3             # ack-less retry exhaustions => failover
    # degraded-mode controller: conservative by construction
    min_confidence: float = 0.7
    confirmations: int = 3
    cooldown: float = 5.0
    # chaos: scheduled partition of the OOB management port to the
    # *primary* sidecar — heartbeat/bus-counter reads and lease renewals
    # all fail inside the window.  Pure clock comparison, zero RNG.
    oob_partition_start: float = -1.0
    oob_partition_s: float = 0.0


class Watchdog:
    """Liveness supervisor + degraded host-side fallback around a sidecar."""

    NORMAL = "normal"
    STANDBY = "standby"            # hot standby sidecar holds the lease
    FALLBACK = "fallback"

    def __init__(self, sidecar: DPUSidecar,
                 params: WatchdogParams | None = None,
                 tables: tuple[str, ...] = DEFAULT_TABLES,
                 mitigate: bool = True,
                 standby: DPUSidecar | None = None,
                 lease: LeaseParams | None = None) -> None:
        self.sidecar = sidecar
        self.params = params or WatchdogParams()
        # the standby plane detects + attributes only; actuation goes
        # through the (gated) fallback controller below
        self.standby = TelemetryPlane(n_nodes=sidecar.plane.n_nodes,
                                      mitigate=False, tables=tables)
        self.fallback: MitigationController | None = None
        if mitigate:
            p = self.params
            self.fallback = MitigationController(
                engine=None, min_confidence=p.min_confidence,
                confirmations=p.confirmations, cooldown=p.cooldown)
        self.state = self.NORMAL
        self.failovers = 0
        self.failbacks = 0
        self.failover_ts = -1.0
        self._retained: list[EventBatch] = []
        # count-cap evictions: batches dropped while still inside the
        # retain_s horizon.  Nonzero means the replay window is silently
        # narrower than configured — exactly the condition the
        # META_MON_RETAIN probe gauge makes observable
        self.retain_evictions = 0
        # observability (observe-only; None = disabled)
        self.tracer = None
        self._next_probe = 0.0
        self._alive_since = -1.0      # first healthy probe after failover
        self._att_i = 0               # standby attributions already consumed
        self._dark_atts = []          # dark-window evidence for the handover
        self._handover = []           # staged evidence awaiting quarantine end
        self._handover_esc = {}       # drained escalations riding the handover
        self._exh_seen = 0            # bus exhaustion watermark (OOB read)
        self._ack_seen = 0
        self._builder = EventBatchBuilder()
        # last heartbeat value actually read over the OOB port: identical
        # to reading live while the port is up; frozen across a partition
        # window so silence accumulates exactly as the host would see it
        self._hb_read = 0.0
        # -- hot-standby pair (all None/inert on a single-DPU deployment,
        # so every pre-standby code path is bit-identical) ----------------
        self.standby_side = standby
        self.arbiter: ElectionArbiter | None = None
        self.fanout: TapFanout | None = None
        self.promotions = 0           # NORMAL -> STANDBY transitions
        self._satt_i = 0              # standby-plane attribution watermark
        self._fence_seen = 0          # fencing-log watermark (probe rows)
        self._host_act_seen = 0       # host-side ack-channel activity
        self._host_act_ts = 0.0
        self._restarts_seen = 0       # primary restarts at promotion time
        self._promote_ts = -1.0
        self._hb_renewed = -1.0       # heartbeat value behind the last renewal
        if standby is not None:
            self.arbiter = ElectionArbiter(lease or LeaseParams())
            self.primary_lease = self.arbiter.register("primary")
            self.standby_lease = self.arbiter.register("standby")
            self.arbiter.register("host")
            recall = self.arbiter.p.recall_s
            for side, side_lease in ((sidecar, self.primary_lease),
                                     (standby, self.standby_lease)):
                side.lease = side_lease
                side.recall_s = recall
                if side.bus is not None:
                    side.bus.lease = side_lease
                    # both buses terminate at the same host actuator: one
                    # shared fencing authority
                    side.bus.fencing = self.arbiter.registry
            self.fanout = TapFanout(sidecar, standby)
            # the primary leads from t=0 under term 1
            self.arbiter.grant("primary", 0.0)

    # -- producer-facing plane protocol -----------------------------------

    def observe_batch(self, batch: EventBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        # retain a replay window so a failover starts warm, not cold
        self._retained.append(batch)
        horizon = float(batch.ts[-1]) - self.params.retain_s
        while self._retained and float(self._retained[0].ts[-1]) < horizon:
            self._retained.pop(0)
        # the time horizon bounds *payload* age, not memory: a tap that
        # flushes many small batches per simulated second can outrun it,
        # so an explicit count cap keeps the window bounded outright
        while len(self._retained) > self.params.retain_max:
            self._retained.pop(0)
            self.retain_evictions += 1
        if self.fanout is not None:
            self.fanout.observe_batch(batch)
        else:
            self.sidecar.observe_batch(batch)
        if self.state == self.FALLBACK:
            self.standby.observe_batch(batch)

    def observe(self, ev) -> None:
        b = EventBatchBuilder()
        b.add(ev.ts, int(ev.kind), ev.node, ev.device, ev.flow, ev.size,
              ev.depth, ev.op, ev.group, ev.meta, ev.replica)
        self.observe_batch(b.build(sort=False))

    @property
    def findings(self):
        merged = self.sidecar.plane.findings + self.standby.findings
        if self.standby_side is not None:
            merged = merged + self.standby_side.plane.findings
        return sorted(merged, key=lambda f: f.ts)

    @property
    def attributions(self):
        merged = (self.sidecar.plane.attributions
                  + self.standby.attributions)
        if self.standby_side is not None:
            merged = merged + self.standby_side.plane.attributions
        return sorted(merged, key=lambda a: a.ts)

    @property
    def actions(self):
        merged = list(self.sidecar.plane.actions)
        if self.standby_side is not None:
            merged.extend(self.standby_side.plane.actions)
        if self.fallback is not None:
            merged.extend(self.fallback.log)
        return sorted(merged, key=lambda r: r.ts)

    @property
    def stats(self):
        return self.sidecar.plane.stats

    @property
    def controller(self):
        return self.sidecar.policy or self.fallback

    def bind(self, engine: EngineControls) -> None:
        self.sidecar.bind(engine)
        if self.standby_side is not None:
            self.standby_side.bind(engine)
        if self.fallback is not None:
            self.fallback.engine = engine

    def attach_tracer(self, tracer, recorder=None) -> None:
        """Thread one shared Tracer through every vantage the watchdog
        supervises.  The flight recorder rides only on the primary
        sidecar's plane (failover replays into the degraded plane are
        historical traffic, not fresh frames).  Observe-only."""
        self.tracer = tracer
        self.sidecar.attach_tracer(tracer, "primary", recorder=recorder)
        if self.standby_side is not None:
            self.standby_side.attach_tracer(tracer, "standby")
        self.standby.tracer = tracer
        self.standby.trace_source = "fallback"
        if self.arbiter is not None:
            self.arbiter.tracer = tracer

    # -- actuations routed back from the host ------------------------------

    def force_failover(self, now: float) -> bool:
        """``failover_controller`` actuation target (idempotent).

        Only a NORMAL-state watchdog actually fails over.  A force landing
        during an already-degraded window (FALLBACK, or a hot standby
        already leading) is a no-op that must NOT reset ``failover_ts``:
        the dark-window evidence staging keys off the *original* failover
        instant, and re-stamping it would silently drop everything the
        fallback observed before the redundant force landed.
        """
        if self.state == self.NORMAL:
            self._failover(now)
            if self.arbiter is not None:
                self.arbiter.revoke("primary", now)
                if self.arbiter.can_promote("host", now):
                    self.arbiter.grant("host", now)
        return True

    def resync(self, now: float) -> None:
        """``resync_telemetry`` passthrough to the sidecar's ingest guard."""
        self.sidecar.resync(now)

    def remirror(self, now: float) -> bool:
        """``remirror_standby`` actuation: replay the retained tap window
        into the lagging standby sidecar and resync its sequence stream,
        catching its detector state back up to the primary's."""
        if self.standby_side is None:
            return False
        sb = self.standby_side
        sb.plane.reset_detector_state()
        sb.plane.warm_start(self._retained)
        sb.guard.resync()
        # the replay came off the host-side retained window, so the
        # standby's view of tap time catches up to what it replayed
        if self._retained:
            sb._tap_clock = max(sb._tap_clock,
                                float(self._retained[-1].ts[-1]))
            sb._stream_clock = max(sb._stream_clock, sb._tap_clock)
        return True

    def fence_stale(self, now: float) -> bool:
        """``fence_stale_controller`` actuation: deliver the currently
        granted term to any deposed-but-alive sidecar so it quiesces, and
        purge its outstanding commands — the fence already rejected what
        arrived; this stops the stale retry stream at its source."""
        if self.arbiter is None:
            return False
        term = self.arbiter.registry.term
        for side in (self.sidecar, self.standby_side):
            if side is None or side.lease is None:
                continue
            if side.lease.term < term:
                # a delivered step-down notice, Raft-style: the deposed
                # sidecar learns the current term (its future pings stop
                # reading as split-brain attempts) but NOT a lease — it
                # stays quiesced until the arbiter grants it one again
                side.lease.term = term
                side.lease.lease_until = min(side.lease.lease_until, now)
                if side.bus is not None:
                    side.bus.drop_outstanding()
        return True

    # -- the supervision loop ----------------------------------------------

    def _oob_dark(self, now: float) -> bool:
        """True inside the scheduled OOB-port partition window (pure clock
        comparison, mirroring ``ModeledLink.partitioned``)."""
        p = self.params
        return (p.oob_partition_start >= 0.0
                and p.oob_partition_start <= now
                < p.oob_partition_start + p.oob_partition_s)

    def _host_probe_alive(self, now: float) -> bool:
        """Corroborating host-side probe, sharing no path with the OOB
        port: the ack channel's send counter advances *host-side* every
        time the actuator answers the primary (pings included), so a
        primary that is actuating is visibly alive from the host's end of
        the wire even when the OOB port is partitioned.  This is the
        second opinion the split-brain guard demands before a promotion."""
        if self.sidecar.crashed:
            return False
        bus = self.sidecar.bus
        if bus is None:
            return False
        activity = bus.ack.sent + bus.stats.applied
        if activity > self._host_act_seen:
            self._host_act_ts = now
        self._host_act_seen = activity
        return now - self._host_act_ts <= self.params.silence_timeout

    def advance(self, now: float) -> None:
        self.sidecar.advance(now)
        if self.standby_side is not None:
            self.standby_side.advance(now)
        self._deliver_handover(now)
        p = self.params
        if now < self._next_probe:
            self._drive_fallback()
            return
        self._next_probe = now + p.probe_every
        # the heartbeat is read over the OOB port: while a partition window
        # is scheduled the last-read value freezes and silence accumulates
        # (with no window configured this is exactly the live read)
        oob_dark = self._oob_dark(now)
        if not oob_dark:
            self._hb_read = self.sidecar.heartbeat_ts
        silence = now - self._hb_read
        silent = silence > p.silence_timeout
        # OOB management-port read of the bus counters: retry exhaustion
        # with zero intervening acks means the command channel is dark even
        # though the DPU itself is alive.  Only *live* acks re-arm the
        # watermark — a late straggler's stale/superseded nack closes out
        # retry state without proving the channel carries current traffic.
        bus = self.sidecar.bus
        bus_dark = False
        if bus is not None and not oob_dark:
            s = bus.stats
            if s.live_acked > self._ack_seen:
                self._exh_seen = s.exhausted   # channel round-trips; re-arm
            elif s.exhausted - self._exh_seen >= p.exhaust_min:
                bus_dark = True
            self._ack_seen = s.live_acked
        if self.arbiter is not None and silent:
            # an OOB-silent primary that the host-side data path can still
            # see actuating is partitioned, not dead: without this
            # corroboration a mere management-port blip would depose a
            # healthy leader (the textbook split-brain opener)
            silent = not self._host_probe_alive(now)
        # probe rows feed the standby plane's mon detectors (heartbeat
        # always; bus health only while it is dark, mirroring the sidecar's
        # own latched emission)
        b = self._builder
        b.add(now, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
              1 if silent else 0, int(silence * 1000), -1, -1,
              META_MON_HEARTBEAT, -1)
        if self._retained:
            # retained-window gauge: occupancy (batches) + payload span
            # (ms).  A span visibly below retain_s (count-cap evictions)
            # is what makes a thin remirror_standby replay *observable*
            # instead of inferred after the fact
            span_ms = int((float(self._retained[-1].ts[-1])
                           - float(self._retained[0].ts[-1])) * 1000.0)
            b.add(now, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
                  len(self._retained), span_ms, -1, -1,
                  META_MON_RETAIN, -1)
        if bus_dark:
            b.add(now, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
                  bus.stats.exhausted, bus.stats.retries, -1, -1,
                  META_MON_BUS, -1)
        if self.standby_side is not None:
            # standby-shadow probe: how far is the standby's detector state
            # behind the primary's?  Clamped at zero — a *primary* falling
            # behind is the outage/blackout rows' business, not this one's
            lag_ms = max(0, int((self.sidecar._tap_clock
                                 - self.standby_side._tap_clock) * 1000.0))
            b.add(now, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
                  lag_ms, 0 if self.standby_side.crashed else 1, -1, -1,
                  META_MON_STANDBY, -1)
            fenced = len(self.arbiter.registry.fenced)
            if fenced > self._fence_seen:
                b.add(now, int(EventKind.QUEUE_SAMPLE), -1, -1, -1,
                      fenced - self._fence_seen,
                      self.arbiter.registry.term, -1, -1,
                      META_MON_FENCE, -1)
                self._fence_seen = fenced
        self.standby.observe_batch(b.build(sort=False))
        b.clear()
        healthy = not silent and not bus_dark
        if self.arbiter is None:
            # single-DPU deployment: the two-state machine, verbatim
            if self.state == self.NORMAL and not healthy:
                self._failover(now)
            elif self.state == self.FALLBACK:
                if healthy:
                    if self._alive_since < 0:
                        self._alive_since = now
                    elif now - self._alive_since >= p.failback_hold:
                        self._failback(now)
                else:
                    self._alive_since = -1.0
        else:
            self._arbitrate(now, healthy, oob_dark)
        self._drive_fallback()

    def _standby_alive(self, now: float) -> bool:
        sb = self.standby_side
        return (sb is not None and not sb.crashed
                and now - sb.heartbeat_ts <= self.params.silence_timeout)

    def _arbitrate(self, now: float, healthy: bool, oob_dark: bool) -> None:
        """Lease-arbiter state machine (hot standby attached)."""
        p, arb = self.params, self.arbiter
        standby_ok = self._standby_alive(now)
        if self.state == self.NORMAL:
            if healthy:
                if oob_dark:
                    # renewals ride the OOB port; inside a partition window
                    # the arbiter tries and fails — the primary's lease
                    # keeps counting down toward expiry
                    arb.renew(now, delivered=False)
                elif self._hb_read > self._hb_renewed:
                    # renew only against a heartbeat that visibly advanced:
                    # a frozen heartbeat still inside the silence tolerance
                    # must not extend the horizon, or every promotion pays
                    # detection latency PLUS a full lease on top
                    self._hb_renewed = self._hb_read
                    arb.renew(now)
                return
            # primary suspect: stop renewing.  Promotion requires every
            # previously delivered lease horizon to have expired first —
            # the at-most-one-actuator invariant is enforced here, not
            # hoped for
            if not oob_dark:
                # the management port still reaches the primary (dark *bus*,
                # not dark OOB): deliver an explicit demotion instead of
                # waiting out its lease horizon.  A partitioned OOB port
                # cannot deliver the notice, so there the horizon wait is
                # mandatory — that is the split-brain guard.
                arb.revoke("primary", now)
            if not arb.can_promote("standby", now):
                return
            if standby_ok:
                self._promote_standby(now)
            else:
                # both sidecars dark: degraded host mode (single-DPU path), with
                # the host taking the term so zombie commands stay fenced
                self._failover(now)
                arb.grant("host", now)
        elif self.state == self.STANDBY:
            if standby_ok:
                arb.renew(now)
            primary_back = healthy and not oob_dark
            if primary_back:
                if self._alive_since < 0:
                    self._alive_since = now
                elif now - self._alive_since >= p.failback_hold:
                    self._demote_standby(now)
                    return
            else:
                self._alive_since = -1.0
            if not standby_ok and not healthy:
                # dual-dark mid-incident: revoke the (dead) standby's lease
                # and degrade to host mode once its horizon clears
                arb.revoke("standby", now)
                if arb.can_promote("host", now):
                    self._failover(now)
                    arb.grant("host", now)
        elif self.state == self.FALLBACK:
            if healthy and not oob_dark:
                if self._alive_since < 0:
                    self._alive_since = now
                elif now - self._alive_since >= p.failback_hold:
                    self._failback(now)
                    arb.revoke("host", now)
                    arb.grant("primary", now)
            else:
                self._alive_since = -1.0

    def _promote_standby(self, now: float) -> None:
        """Hot failover: the standby's detectors are already warm — the
        promotion costs one lease grant, not a replay re-warm."""
        term = self.arbiter.grant("standby", now)
        if term == 0:
            return
        self.state = self.STANDBY
        self.promotions += 1
        if self.tracer is not None:
            self.tracer.on_transition("promote_standby", now, "watchdog",
                                      term=term)
        self._alive_since = -1.0
        self._promote_ts = now
        self._satt_i = len(self.standby_side.plane.attributions)
        self._restarts_seen = self.sidecar.restarts
        # the demotion handover must reach back past the promotion
        # instant: evidence the standby attributed while still shadowing
        # (e.g. a quorum row's one-shot findings that landed during the
        # primary's death throes) exists nowhere else once the primary's
        # own recall buffer died with it
        self._dark_atts = [
            a for a in self.standby_side.plane.attributions
            if a.ts >= now - self.standby_side.recall_s]
        # replay the recall buffer: confirmation counts resume where the
        # deposed leader's would have been
        self.standby_side.on_lease_granted(now)

    def _demote_standby(self, now: float) -> None:
        """Hysteretic failback from the hot standby to the primary."""
        arb = self.arbiter
        arb.revoke("standby", now)
        term = arb.grant("primary", now)
        if term == 0:
            return
        self.state = self.NORMAL
        self.failbacks += 1
        if self.tracer is not None:
            self.tracer.on_transition("demote_standby", now, "watchdog",
                                      term=term)
        self._alive_since = -1.0
        # a pending quorum escalation is lease state, not confirmation
        # state: its one-shot evidence (e.g. per-node findings that landed
        # during the primary's death throes) can never be re-observed by
        # the incoming leader, so the handover carries it — original dwell
        # deadline intact — instead of letting it die with the deposed
        # controller.  Drained BEFORE the quarantine below can clear it.
        if self.standby_side.policy is not None:
            self._handover_esc.update(
                self.standby_side.policy.drain_escalations())
        policy = self.sidecar.policy
        if policy is not None:
            # drop half-confirmed state at the handover boundary (the two
            # controllers must never compose a confirmation chain) without
            # extending any already-open hold
            policy.quarantine(now)
        if self.sidecar.restarts > self._restarts_seen:
            # the primary restarted during the dark window, so its plane
            # re-warmed on fault-era traffic only: replay the retained tap
            # window for honest baselines (the failback state transfer).
            # A deposed-but-alive primary skips this — its detector state
            # never went dark
            self.sidecar.plane.reset_detector_state()
            self.sidecar.plane.warm_start(self._retained)
        # evidence handover, both directions of it: what the standby
        # attributed while it led, and what the primary recalled while
        # shadowing — minus mon rows and minus anything already applied.
        # Routed through the deferred-delivery path so a still-open restart
        # quarantine can never swallow the single copy.
        acted = set()
        if self.standby_side.bus is not None:
            acted = {(r.action, r.node)
                     for r in self.standby_side.bus.log
                     if r.applied and r.ts >= self._promote_ts}
        for a in self._dark_atts + self.sidecar.drain_recall():
            entry = BY_ID.get(a.primary.name)
            if entry is None or entry.table == "mon":
                continue
            if (entry.action, a.node) in acted:
                continue
            self._handover.append(a)
        self._dark_atts = []

    def _failover(self, now: float) -> None:
        self.state = self.FALLBACK
        self.failovers += 1
        if self.tracer is not None:
            self.tracer.on_transition(
                "failover", now, "watchdog",
                retained_batches=len(self._retained))
        self.failover_ts = now
        self._alive_since = -1.0
        self._dark_atts = []
        self._handover = []           # stale evidence must not outlive a new outage
        self._handover_esc = {}
        # until now the standby's only traffic was probe rows — to its
        # detectors every node has been silent since t=0.  Re-warm from a
        # clean slate: drop that probe-only history, then replay the
        # retained tap window so baselines span real recent traffic
        self.standby.reset_detector_state()
        for batch in self._retained:
            self.standby.observe_batch(batch)

    def _failback(self, now: float) -> None:
        self.state = self.NORMAL
        self.failbacks += 1
        if self.tracer is not None:
            self.tracer.on_transition("failback", now, "watchdog")
        self._alive_since = -1.0
        # the live tee stops here; without a reset the standby's detectors
        # would read the taper as cluster-wide starvation on the next probe
        self.standby.reset_detector_state()
        # drop half-confirmed policy state at the handover so the two
        # controllers can never compose a confirmation chain across it —
        # but do NOT extend the actuation hold: the restart path already
        # opened its own quarantine, and stacking another full window on
        # top of it would swallow the one shot a latching detector gets
        # at the first post-reset poll
        policy = self.sidecar.policy
        if policy is not None:
            policy.quarantine(now)
        # state transfer: the restarted DPU re-warmed on fault-era traffic,
        # so its baselines think the pathology is normal — rate/peak-latch
        # rows would never fire again.  Replay the supervisor's retained
        # tap window (spans pre-incident traffic) into the returning plane
        # with logging suppressed; the next live poll then detects against
        # honest baselines
        self.sidecar.plane.reset_detector_state()
        self.sidecar.plane.warm_start(self._retained)
        # evidence handover: attributions the standby observed while the
        # DPU was dark are re-staged through the primary's own arbitration
        # — minus the mon rows (the DPU's own obituary; the outage is over
        # by definition of failback) and minus anything the fallback
        # already applied.  Delivery is deferred until the restart
        # quarantine has actually expired: failback and quarantine-end can
        # land microseconds apart, and evidence staged inside the hold is
        # dropped — fatal for a single-copy handover
        acted = set()
        if self.fallback is not None:
            acted = {(r.action, r.node) for r in self.fallback.log
                     if r.applied and r.ts >= self.failover_ts}
        for a in self._dark_atts:
            entry = BY_ID.get(a.primary.name)
            if entry is None or entry.table == "mon":
                continue
            if (entry.action, a.node) in acted:
                continue
            self._handover.append(a)
        self._dark_atts = []

    def _deliver_handover(self, now: float) -> None:
        if not self._handover and not self._handover_esc:
            return
        policy = self.sidecar.policy
        if policy is None or self.state != self.NORMAL:
            self._handover = []
            self._handover_esc = {}
            return
        if now < policy.quarantine_until:
            return
        for a in self._handover:
            policy.observe(a)
        self._handover = []
        if self._handover_esc:
            policy.adopt_escalations(self._handover_esc, now)
            self._handover_esc = {}

    def _drive_fallback(self) -> None:
        """Feed new standby attributions to the degraded controller.  Only
        FALLBACK state actuates the full table set; attributions arriving
        while NORMAL are consumed (watermark) but not acted on — the DPU
        path owns them.  With the lease arbiter attached, mon-table rows
        actuate host-side in *every* state: they are the watchdog's own
        probe-row detections (standby lag, split-brain fencing), and their
        remedies (``remirror_standby``, ``fence_stale_controller``) target
        the watchdog itself — no sidecar can self-actuate them."""
        if self.state == self.STANDBY:
            # evidence the leading standby attributes is staged for the
            # demotion handover, exactly like FALLBACK's dark window
            satts = self.standby_side.plane.attributions
            self._dark_atts.extend(satts[self._satt_i:])
            self._satt_i = len(satts)
        atts = self.standby.attributions
        if self.fallback is None or not atts[self._att_i:]:
            self._att_i = len(atts)
            return
        fresh = atts[self._att_i:]
        self._att_i = len(atts)
        if self.state == self.FALLBACK:
            self._dark_atts.extend(fresh)
            recs = self.fallback.consider_all(fresh)
        elif self.arbiter is not None:
            mon = [a for a in fresh
                   if (e := BY_ID.get(a.primary.name)) is not None
                   and e.table == "mon"]
            if not mon:
                return
            recs = self.fallback.consider_all(mon)
        else:
            return
        if recs:
            self.standby.actions.extend(recs)
            self.standby.agent.stats.actions += len(recs)

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        out = self.sidecar.report()
        out["watchdog"] = {
            "state": self.state,
            "failovers": self.failovers,
            "failbacks": self.failbacks,
            "standby_findings": len(self.standby.findings),
            "fallback_actions": (len(self.fallback.log)
                                 if self.fallback else 0),
            "retained_batches": len(self._retained),
            "retained_span_s": (
                float(self._retained[-1].ts[-1])
                - float(self._retained[0].ts[-1])
                if self._retained else 0.0),
            "retain_evictions": self.retain_evictions,
        }
        if self.arbiter is not None:
            out["watchdog"]["promotions"] = self.promotions
            out["watchdog"]["election"] = self.arbiter.report()
        return out
