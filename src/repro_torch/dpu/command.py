"""Command bus — reliable-ish delivery of mitigation commands to the host.

The downlink half of the control loop: commands cross a ``ModeledLink`` to
the host actuator, the actuation result crosses another link back as an
ack, and the bus supervises the exchange the way a real DPU control agent
must:

  retries             — an unacked command is re-sent on an exponential
                        backoff schedule (``ack_timeout`` doubled per
                        attempt by ``ack_backoff``, capped at
                        ``ack_timeout_cap``) up to ``max_retries`` attempts
                        (each resend re-risks the wire);
  exhaustion          — a command that burns every retry unacked counts in
                        ``BusStats.exhausted`` and fires ``on_expired``;
                        the sidecar surfaces the exhaustion rate as
                        self-telemetry so a partitioned command channel is
                        itself a detectable pathology (``command_partition``
                        row);
  liveness pings      — zero-cost ``PING_ACTION`` commands are acked by the
                        host without touching the actuator, giving the bus
                        an ack stream to measure even when the policy engine
                        is quiet;
  idempotent delivery — a retry that races a slow ack is applied at most
                        once (the host tracks applied cmd ids and re-acks);
  stale invalidation  — a command older than ``stale_after`` at delivery
                        time is discarded unapplied: the evidence that
                        produced it no longer describes the cluster;
  supersession        — if a newer command for the same (action, node) has
                        already been applied, an older straggler is dropped.

Every applied command is recorded as a ``core.mitigation.ActionRecord``
(host-clock timestamped) so closed-loop consumers see one action log
regardless of whether the instant controller or the DPU path produced it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.mitigation import ActionRecord, EngineControls
from repro_torch.dpu.policy import Command
from repro_torch.dpu.transport import LinkParams, ModeledLink

#: Liveness probe pseudo-action: acked by the host, never actuated.
PING_ACTION = "__ping__"


@dataclass
class _Outstanding:
    cmd: Command
    attempt: int
    last_sent: float


@dataclass
class BusStats:
    sent: int = 0
    retries: int = 0
    acked: int = 0
    applied: int = 0
    rejected: int = 0            # delivered but actuator returned False
    stale_dropped: int = 0
    superseded: int = 0
    duplicates: int = 0          # retry arrived after the original applied
    expired: int = 0             # gave up (retry exhaustion OR staleness)
    exhausted: int = 0           # subset of expired: burned every retry
    fenced: int = 0              # stale-term command rejected by the actuator
    # acks for *current* exchanges only: pings, applies, duplicate re-acks.
    # A negative ack for a stale/superseded/fenced command closes out its
    # retry state but is NOT channel liveness — a late straggler's nack
    # must not clear an exhaustion latch (see sidecar self-telemetry).
    live_acked: int = 0
    extra: dict = field(default_factory=dict)


class CommandBus:
    """Down/ack link pair + retry supervisor around one host actuator."""

    def __init__(self, engine: EngineControls | None, rng,
                 down: LinkParams | None = None,
                 ack: LinkParams | None = None,
                 ack_timeout: float = 20e-3,
                 max_retries: int = 3,
                 stale_after: float = 0.5,
                 ack_backoff: float = 2.0,
                 ack_timeout_cap: float = 0.25,
                 on_ack=None,
                 on_expired=None) -> None:
        self.engine = engine
        self.down = ModeledLink(down or LinkParams(), rng)
        self.ack = ModeledLink(ack or down or LinkParams(), rng)
        self.ack_timeout = ack_timeout
        self.max_retries = max_retries
        self.stale_after = stale_after
        self.ack_backoff = ack_backoff
        self.ack_timeout_cap = ack_timeout_cap
        self.on_ack = on_ack
        self.on_expired = on_expired
        # hot-standby wiring (set by the watchdog when a standby exists):
        # ``lease`` stamps outgoing commands with the sender's term;
        # ``fencing`` is the shared host-actuator authority that rejects
        # stale-term deliveries.  Both None on a legacy single-DPU bus.
        self.lease = None
        self.fencing = None
        # observability (observe-only; None = disabled)
        self.tracer = None
        self.trace_source = ""
        self._outstanding: dict[int, _Outstanding] = {}
        self._applied_ids: set[int] = set()
        # newest applied command id per (action, node): supersession check
        self._newest_applied: dict[tuple[str, int], int] = {}
        self.stats = BusStats()
        self.log: list[ActionRecord] = []

    # -- DPU side --------------------------------------------------------

    def send(self, cmd: Command, now: float) -> None:
        if self.lease is not None and cmd.term == 0:
            # the term is stamped at send time with whatever the sender
            # currently believes — a deposed-but-alive sidecar keeps
            # stamping its stale term, which is exactly what the host's
            # fencing registry needs to see to reject it
            cmd = replace(cmd, term=self.lease.term)
        self.stats.sent += 1
        self._outstanding[cmd.cmd_id] = _Outstanding(cmd, 1, now)
        if self.tracer is not None:
            self.tracer.on_bus("send", cmd, now, self.trace_source)
        self.down.send(now, cmd)

    def drop_outstanding(self) -> int:
        """DPU crash: the retry supervisor's state is DPU DRAM.  In-flight
        commands are simply forgotten — no expiry accounting, no callbacks
        (the policy engine that issued them is being reset too)."""
        n = len(self._outstanding)
        self._outstanding.clear()
        return n

    # -- pump (called once per host round, both clocks agree on ``now``) --

    def advance(self, now: float) -> list[ActionRecord]:
        """Deliver due commands, process acks, drive retries.

        Returns the ActionRecords applied during this call.
        """
        applied_now: list[ActionRecord] = []
        for cmd in self.down.deliver(now):
            applied_now.extend(self._deliver(cmd, now))
        for cmd, ok, live in self.ack.deliver(now):
            if cmd.cmd_id in self._outstanding:
                del self._outstanding[cmd.cmd_id]
                self.stats.acked += 1
                if live:
                    self.stats.live_acked += 1
                if self.tracer is not None:
                    self.tracer.on_bus("ack", cmd, now, self.trace_source,
                                       ok=ok, live=live)
                if self.on_ack is not None:
                    self.on_ack(cmd, ok)
        self._retry(now)
        return applied_now

    def _deliver(self, cmd: Command, now: float) -> list[ActionRecord]:
        if self.fencing is not None and not self.fencing.admit(cmd, now):
            # stale-term sender: every command — pings included — is
            # rejected at the door, the way a Raft follower nacks any RPC
            # carrying an old term.  The nack is how a deposed leader
            # learns; the FencedCommand record is the split-brain audit
            # trail (split_brain_fenced row).
            self.stats.fenced += 1
            if self.tracer is not None:
                self.tracer.on_bus("fenced", cmd, now, self.trace_source,
                                   fence_term=self.fencing.term)
            self.ack.send(now, (cmd, False, False))
            return []
        if cmd.action == PING_ACTION:
            # liveness probe: ack immediately, never touch the actuator,
            # never log an ActionRecord — its only job is to measure the
            # round trip (or fail to, under partition)
            self.ack.send(now, (cmd, True, True))
            return []
        if cmd.cmd_id in self._applied_ids:
            # retry raced the ack: apply-at-most-once, re-ack
            self.stats.duplicates += 1
            self.ack.send(now, (cmd, True, True))
            return []
        if now - cmd.ts > self.stale_after:
            self.stats.stale_dropped += 1
            if self.tracer is not None:
                self.tracer.on_bus("stale", cmd, now, self.trace_source,
                                   age=now - cmd.ts)
            self.ack.send(now, (cmd, False, False))
            return []
        newest = self._newest_applied.get((cmd.action, cmd.node))
        if newest is not None and newest > cmd.cmd_id:
            self.stats.superseded += 1
            if self.tracer is not None:
                self.tracer.on_bus("superseded", cmd, now,
                                   self.trace_source, newest=newest)
            self.ack.send(now, (cmd, False, False))
            return []
        # actuators that need wall time (e.g. ReplicaSet view refresh) read
        # it from the detail; the command's own ts is its decision time
        detail = {**cmd.detail, "now": now}
        if (self.fencing is not None and cmd.term > 0
                and cmd.term < self.fencing.term):
            # belt-and-braces: admit() already fenced stale terms, so this
            # counter staying zero is the at-most-one-actuator proof the
            # chaos lane asserts
            self.fencing.stale_applied += 1
        if self.tracer is not None:
            # before the actuator runs, so the synchronous apply hook can
            # attribute its decided_ts to this command's issue time
            self.tracer.on_bus("deliver", cmd, now, self.trace_source,
                               attempt_age=now - cmd.ts)
        ok = (self.engine.apply_action(cmd.action, cmd.node, detail)
              if self.engine is not None else False)
        self._applied_ids.add(cmd.cmd_id)
        self._newest_applied[(cmd.action, cmd.node)] = cmd.cmd_id
        self.stats.applied += 1
        if not ok:
            self.stats.rejected += 1
        rec = ActionRecord(ts=now, action=cmd.action, node=cmd.node,
                           row_id=cmd.row_id, locus=cmd.locus, applied=ok,
                           detail=cmd.detail)
        self.log.append(rec)
        self.ack.send(now, (cmd, ok, True))
        return [rec]

    def backoff_delay(self, attempt: int) -> float:
        """Wait before resend number ``attempt + 1`` — exponential in the
        attempts already made, capped so a long partition cannot push the
        next probe past any useful horizon."""
        return min(self.ack_timeout * self.ack_backoff ** (attempt - 1),
                   self.ack_timeout_cap)

    def _retry(self, now: float) -> None:
        for cid in list(self._outstanding):
            st = self._outstanding[cid]
            if now - st.last_sent < self.backoff_delay(st.attempt):
                continue
            if (st.attempt >= self.max_retries
                    or now - st.cmd.ts > self.stale_after):
                del self._outstanding[cid]
                self.stats.expired += 1
                if st.attempt >= self.max_retries:
                    self.stats.exhausted += 1
                if self.tracer is not None:
                    self.tracer.on_bus(
                        "expired", st.cmd, now, self.trace_source,
                        attempts=st.attempt,
                        exhausted=st.attempt >= self.max_retries)
                if self.on_expired is not None:
                    self.on_expired(st.cmd, st.attempt >= self.max_retries)
                continue
            st.attempt += 1
            st.last_sent = now
            self.stats.retries += 1
            if self.tracer is not None:
                self.tracer.on_bus("retry", st.cmd, now, self.trace_source,
                                   attempt=st.attempt)
            self.down.send(now, st.cmd)
