"""Leader lease + fencing for the standby-DPU hot-failover pair.

Production monitoring planes run *two* BlueField sidecars per node: a
primary that actuates and a standby that shadows the same telemetry tap
(see ``TapFanout`` in :mod:`repro_torch.dpu.transport`).  Exactly one of them
may drive mitigation at any instant.  This module models the control
half of that contract:

* ``LeaderLease`` — one sidecar's local view of its authority: a term
  number plus an expiry instant, both written only by renewal/grant
  messages delivered over the modeled OOB management port.
* ``ElectionArbiter`` — the host-side lease issuer (owned by the
  watchdog, which already speaks the OOB port).  Terms are monotone and
  a new term is granted only once every previously *delivered* lease
  horizon has expired — at-most-one-valid-lease holds by construction,
  not by luck (this is the invariant the property tests hammer).
* ``FencingRegistry`` — the host actuator's view of the current term.
  The ``CommandBus`` stamps every command with the issuing sidecar's
  term and the delivery path rejects (and records) anything older than
  the registry's granted term, so a deposed-but-alive sidecar cannot
  double-actuate even while it still believes it leads.

Determinism contract: nothing in here touches an RNG and nothing reads
a wall clock — every decision is a pure comparison against the caller's
simulated ``now``, so runs with the standby disabled are bit-identical
to the pre-standby code paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LeaseParams:
    """Knobs for the OOB lease protocol.

    ``lease_s`` is deliberately *shorter* than the watchdog's silence
    timeout (0.08 s): renewals are only issued against a heartbeat that
    visibly advanced, so a dead primary's horizon expires before its
    silence even trips — the hot promotion then costs exactly one
    failure-detection latency, the same price the degraded host failover
    pays, instead of detection *plus* a full lease horizon.
    """

    lease_s: float = 0.06    # validity horizon per delivered renewal
    renew_every: float = 0.02  # arbiter renewal cadence (= watchdog probe)
    recall_s: float = 1.3    # attribution recall replayed on promotion


class LeaderLease:
    """One sidecar's locally-held lease (DPU-DRAM state).

    Written only by the arbiter's delivered messages; read by the
    sidecar (``holds``) to gate policy arbitration and by its
    ``CommandBus`` to stamp outgoing command terms.
    """

    def __init__(self, holder: str) -> None:
        self.holder = holder
        self.term = 0
        self.lease_until = float("-inf")
        self.grants = 0

    def holds(self, now: float) -> bool:
        return now < self.lease_until

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LeaderLease({self.holder!r}, term={self.term}, "
                f"until={self.lease_until:.3f})")


@dataclass(frozen=True)
class FencedCommand:
    """Audit record of one rejected stale-term command."""

    ts: float
    term: int          # stale term the command carried
    granted_term: int  # authority in force at rejection time
    action: str
    node: int
    row_id: str


@dataclass
class FencingRegistry:
    """Host-actuator authority: highest granted term + fencing log.

    Shared by every ``CommandBus`` in the node (primary, standby, host)
    because they all terminate at the same actuator.  ``stale_applied``
    counts commands that reached ``apply`` with an out-of-date term —
    it must stay zero; the chaos lane asserts it.
    """

    term: int = 0
    holder: str = ""
    fenced: list = field(default_factory=list)
    stale_applied: int = 0

    def admit(self, cmd, now: float) -> bool:
        """True if ``cmd``'s term is current.  A stale term is fenced
        and recorded; term 0 marks a legacy/unleased bus and always
        passes (fencing is opt-in per bus)."""
        if cmd.term == 0 or cmd.term >= self.term:
            return True
        self.fenced.append(FencedCommand(
            ts=now, term=cmd.term, granted_term=self.term,
            action=cmd.action, node=cmd.node, row_id=cmd.row_id))
        return False


class ElectionArbiter:
    """Host-side lease issuance over the OOB management port.

    The arbiter tracks, per holder, the newest lease horizon it has ever
    *delivered* (``_horizon``).  Renewals that fail delivery (OOB
    partition) advance nothing, so the holder's horizon freezes exactly
    where its local lease will expire.  ``grant`` refuses to start a new
    term while any other holder's delivered horizon is still in the
    future — two valid leases can therefore never overlap, regardless of
    how heartbeat loss, expiry, and partition windows interleave.
    """

    def __init__(self, params: LeaseParams | None = None) -> None:
        self.p = params or LeaseParams()
        self.registry = FencingRegistry()
        self.leases: dict[str, LeaderLease] = {}
        self._horizon: dict[str, float] = {}
        self.leader: str | None = None
        self.grants = 0
        self.renewals = 0
        self.lost_renewals = 0
        # observability (observe-only; None = disabled)
        self.tracer = None

    def register(self, holder: str) -> LeaderLease:
        lease = self.leases.get(holder)
        if lease is None:
            lease = LeaderLease(holder)
            self.leases[holder] = lease
            self._horizon[holder] = float("-inf")
        return lease

    def holder_valid(self, holder: str, now: float) -> bool:
        lease = self.leases.get(holder)
        return (lease is not None and lease.holds(now)
                and lease.term == self.registry.term)

    def valid_holders(self, now: float) -> list:
        """Holders with a live lease at the current term (<= 1 always)."""
        return [h for h in self.leases if self.holder_valid(h, now)]

    def can_promote(self, holder: str, now: float) -> bool:
        """True when no *other* holder's delivered horizon is still live."""
        return all(now >= hz for h, hz in self._horizon.items()
                   if h != holder)

    def renew(self, now: float, delivered: bool = True) -> bool:
        """Extend the current leader's lease by ``lease_s``.

        ``delivered=False`` models an OOB partition: the arbiter tried,
        but the sidecar-side lease object never learned — its horizon
        stays wherever the last delivered renewal put it.
        """
        if self.leader is None:
            return False
        if not delivered:
            self.lost_renewals += 1
            return False
        lease = self.leases[self.leader]
        lease.term = self.registry.term  # renewals carry the term
        lease.lease_until = now + self.p.lease_s
        self._horizon[self.leader] = max(
            self._horizon[self.leader], lease.lease_until)
        self.renewals += 1
        return True

    def revoke(self, holder: str, now: float) -> None:
        """Delivered demotion notice: the holder's lease ends *now*."""
        lease = self.leases.get(holder)
        if lease is None:
            return
        lease.lease_until = min(lease.lease_until, now)
        self._horizon[holder] = min(self._horizon[holder], now)
        if self.leader == holder:
            self.leader = None
        if self.tracer is not None:
            self.tracer.on_transition("lease_revoke", now, "arbiter",
                                      holder=holder, term=lease.term)

    def grant(self, holder: str, now: float,
              delivered: bool = True) -> int:
        """Promote ``holder`` under a fresh term; returns the term, or 0
        if refused (some other delivered lease could still be valid).

        Granting to the current leader is a renewal, not a new term.
        ``delivered=False`` bumps the host-side authority (the fencing
        registry) without the sidecar learning its new lease — it models
        a grant lost on the OOB wire; the holder stays quiesced until a
        later delivered renewal.
        """
        self.register(holder)
        if self.leader == holder:
            self.renew(now, delivered)
            return self.registry.term
        if not self.can_promote(holder, now):
            return 0
        self.registry.term += 1
        self.registry.holder = holder
        self.leader = holder
        self.grants += 1
        if self.tracer is not None:
            self.tracer.on_transition("lease_grant", now, "arbiter",
                                      holder=holder,
                                      term=self.registry.term,
                                      delivered=delivered)
        lease = self.leases[holder]
        if delivered:
            lease.term = self.registry.term
            lease.lease_until = now + self.p.lease_s
            lease.grants += 1
            self._horizon[holder] = max(
                self._horizon[holder], lease.lease_until)
        return self.registry.term

    def report(self) -> dict:
        return {
            "term": self.registry.term,
            "leader": self.leader,
            "grants": self.grants,
            "renewals": self.renewals,
            "lost_renewals": self.lost_renewals,
            "fenced": len(self.registry.fenced),
            "stale_applied": self.registry.stale_applied,
        }
