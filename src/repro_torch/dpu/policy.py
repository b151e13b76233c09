"""On-DPU policy engine — arbitration layer between attribution and action.

``core.mitigation.MitigationController`` (retained as the *instant*-mode
reference) maps one attribution to one action with per-key hysteresis.  At
cluster scale the DPU sees *concurrent* attributions — several rows firing
across nodes and replicas within one decision interval — and a command
channel with real latency and loss, so naive per-finding actuation thrashes.
This engine adds the arbitration the controller lacks:

  priority            — critical beats warn, then confidence, then score;
  confirmations       — repeated evidence per (action, node) before
                        actuating (critical short-circuits) — deliberately
                        the controller's exact hysteresis, so instant-mode
                        and dpu-mode decisions differ only by the modeled
                        loop latency on any scenario both can handle;
  quorum escalation   — the same (row, action) reported by >= ``quorum``
                        distinct nodes in one decision round is a cluster
                        incident; it actuates as one cluster-wide command
                        after a ``dwell`` holdoff.  This rescues one-shot
                        rows whose self-calibrating detector fires each
                        node exactly once (per-node hysteresis can never
                        confirm those), and the dwell keeps the escalated
                        path strictly slower than a working per-node one;
  per-action cooldown — an issued (action, node) pair is held down for
                        ``cooldown`` seconds;
  flap damping        — if the same pair keeps re-triggering (fire, clear,
                        fire), its effective cooldown backs off
                        exponentially — an oscillation guard against
                        detector/actuation limit cycles;
  conflict resolution — actions touching the same control surface on the
                        same node (admission knobs, routing knobs, ...) are
                        arbitrated: only the top-priority one is issued per
                        decision round, the rest are recorded as suppressed.

The confidence floor defaults to 0.5 (the controller uses 0.6): the
arbitration and confirmation gates above make weaker single-vantage
attributions safe to act on, which is precisely what lets the DPU path
recover the straggler-default (confidence-0.5) rows the instant controller
ignores.

The engine is transport-agnostic: ``decide`` returns ``Command`` records;
the caller (``DPUSidecar``) hands them to a ``CommandBus``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.attribution import Attribution
from repro_torch.core.mitigation import ACTIONS
from repro_torch.core.runbooks import BY_ID

#: actions that steer the same control surface; issuing two members against
#: one node in one decision round would fight each other
CONFLICT_GROUPS: dict[str, str] = {}
for _group, _members in (
    ("admission", ("smooth_admission", "admission_control",
                   "widen_batch_window", "shrink_batch")),
    ("routing", ("rebalance_frontend", "rebalance_replicas",
                 "rebalance_nodes", "reroute_traffic", "qos_partition",
                 "reroute_rail")),
    ("placement", ("rebalance_shards", "repartition_stages",
                   "rebalance_microbatches", "inflight_remap")),
    ("transport", ("tune_transport", "widen_rdma_window",
                   "enlarge_egress_buffers", "compress_kv")),
):
    for _a in _members:
        CONFLICT_GROUPS[_a] = _group

_SEV_RANK = {"critical": 2, "warn": 1}


@dataclass(frozen=True)
class Command:
    """One mitigation directive bound for a host actuator."""

    cmd_id: int
    ts: float                 # decision time (DPU clock)
    action: str
    node: int
    row_id: str
    locus: str
    # leader-lease term stamped by the CommandBus at send time.  0 marks
    # a legacy/unleased bus; the host actuator fences anything below the
    # currently granted term (see repro_torch.dpu.election.FencingRegistry).
    term: int = 0
    detail: dict = field(default_factory=dict, compare=False)


class PolicyEngine:
    """Attribution arbitration with cooldown, damping, and conflicts."""

    def __init__(self, min_confidence: float = 0.5,
                 confirmations: int = 2,
                 cooldown: float = 5.0,
                 flap_window: float = 2.0,
                 flap_limit: int = 2,
                 flap_backoff: float = 2.0,
                 quorum: int = 3,
                 quorum_dwell: float = 1.6) -> None:
        self.min_confidence = min_confidence
        self.confirmations = confirmations
        self.cooldown = cooldown
        self.flap_window = flap_window
        self.flap_limit = flap_limit
        self.flap_backoff = flap_backoff
        self.quorum = quorum
        self.quorum_dwell = quorum_dwell
        self._staged: list[Attribution] = []
        self._pending: dict[tuple[str, int], int] = {}    # (action, node)
        self._last_issued: dict[tuple[str, int], float] = {}
        self._issue_log: dict[tuple[str, int], list[float]] = {}
        # quorum-escalation state, keyed (row, action).  An issued (or
        # redundant) escalation clears its first-seen mark, so a RECURRING
        # cluster incident re-arms: fresh quorum evidence re-seeds the
        # dwell, and the (action, -1) cooldown spaces the re-issues.
        self._first_seen: dict[tuple[str, str], float] = {}
        self._escalations: dict[tuple[str, str], tuple] = {}  # -> (due, att)
        self._next_id = 0
        self.issued: list[Command] = []
        self.suppressed: list[tuple[str, float, str, int, str]] = []
        # actuation quarantine: while now < quarantine_until every decision
        # is suppressed (recorded), so detectors re-warming after an ingest
        # gap / DPU restart can never fire a command off stale state
        self.quarantine_until = float("-inf")
        self.quarantined = 0
        # observability (observe-only; None = disabled)
        self.tracer = None
        self.trace_source = ""

    # -- chaos / hardening hooks -----------------------------------------

    def quarantine(self, until: float) -> None:
        """Open (or extend) the actuation quarantine window and drop every
        half-confirmed decision: post-gap evidence must re-confirm from
        scratch against the re-warmed detectors."""
        if until > self.quarantine_until:
            self.quarantine_until = until
        self._staged.clear()
        self._pending.clear()
        self._first_seen.clear()
        self._escalations.clear()

    def drain_escalations(self) -> dict:
        """Hand off every armed-but-unfired quorum escalation.  Called by
        the watchdog at demotion: a pending cluster-scoped action is part
        of the *lease* state (like a leadership transfer carrying the
        log), not the controller's confirmation chain — dropping it with
        the deposed controller would lose one-shot quorum evidence the
        incoming leader can never re-observe."""
        out = self._escalations
        self._escalations = {}
        return out

    def adopt_escalations(self, esc: dict, now: float) -> None:
        """Install escalations drained from a deposed controller.  The
        original dwell deadline is preserved (never shortened — the
        holdoff that keeps the escalated path slower than a working
        per-node one must survive the handover), and an escalation this
        engine armed on its own evidence wins over the adopted copy."""
        for ekey, (due, a) in esc.items():
            if ekey not in self._escalations:
                self._escalations[ekey] = (max(due, now), a)

    def on_expired(self, cmd: Command, exhausted: bool) -> None:
        """Bus gave up on a command unacked.  Clear the pair's cooldown
        mark: the action never landed, so holding it down would leave the
        fault unactuated for a full cooldown after the channel heals."""
        self._last_issued.pop((cmd.action, cmd.node), None)

    def crash_reset(self, now: float) -> None:
        """DPU power-cycle: everything in DRAM is lost, including cooldown
        and flap history — a command dropped in flight at crash time must
        not hold its (action, node) pair down after restart.  Re-issuing
        after the restart quarantine is safe: it only happens if the
        re-warmed detectors still see the fault, i.e. the action never
        landed (or did not work).  The ``issued``/``suppressed`` logs are
        the experiment record and survive."""
        self.quarantine(now)
        self._last_issued.clear()
        self._issue_log.clear()

    # -- feeding ---------------------------------------------------------

    def observe(self, attribution: Attribution) -> None:
        """Stage one attribution for the next ``decide`` round."""
        self._staged.append(attribution)

    # -- bookkeeping the bus reports back --------------------------------

    def on_ack(self, cmd: Command, applied: bool) -> None:
        """Host acknowledged a command; nothing to re-arm on failure —
        cooldown ran from issue time, so a rejected action retries
        naturally once fresh evidence confirms again."""
        if applied:
            self._pending[(cmd.action, cmd.node)] = 0

    # -- decision --------------------------------------------------------

    def effective_cooldown(self, key: tuple[str, int], now: float) -> float:
        """Base cooldown, backed off exponentially while the pair flaps."""
        recent = [t for t in self._issue_log.get(key, ())
                  if now - t <= self.flap_window]
        extra = max(0, len(recent) - self.flap_limit + 1)
        return self.cooldown * (self.flap_backoff ** extra)

    def _candidates(self, now: float) -> list[tuple[tuple, Attribution, str]]:
        """Filter + confirm staged attributions into actionable candidates."""
        out = []
        round_nodes: dict[tuple[str, str], tuple[set, Attribution]] = {}
        for a in self._staged:
            entry = BY_ID.get(a.primary.name)
            if entry is None or a.confidence < self.min_confidence:
                continue
            ekey = (entry.row_id, entry.action)
            self._first_seen.setdefault(ekey, now)
            seen = round_nodes.get(ekey)
            if seen is None:
                round_nodes[ekey] = ({a.node}, a)
            else:
                seen[0].add(a.node)
            key = (entry.action, a.node)
            hits = self._pending.get(key, 0) + 1
            self._pending[key] = hits
            needed = 1 if a.primary.severity == "critical" \
                else self.confirmations
            if hits < needed:
                continue
            last = self._last_issued.get(key, float("-inf"))
            if now - last < self.effective_cooldown(key, now):
                self.suppressed.append(
                    ("cooldown", now, entry.action, a.node, entry.row_id))
                continue
            out.append((key, a, entry.action))
        self._staged.clear()
        # quorum check: the same (row, action) on >= quorum distinct nodes
        # within one decision round escalates to a deferred cluster command
        for ekey, (nodes, a) in round_nodes.items():
            if len(nodes) >= self.quorum and ekey not in self._escalations:
                due = max(now, self._first_seen[ekey] + self.quorum_dwell)
                self._escalations[ekey] = (due, a)
        return out

    def _due_escalations(self, now: float) -> list[tuple[tuple, Attribution,
                                                         str]]:
        out = []
        for ekey in list(self._escalations):
            due, a = self._escalations[ekey]
            if now < due:
                continue
            del self._escalations[ekey]
            self._first_seen.pop(ekey, None)    # re-arm on fresh evidence
            row_id, action = ekey
            # a successful per-node issue of the same action within its
            # cooldown makes the escalation redundant
            recent = any(k[0] == action
                         and now - t < self.effective_cooldown(k, now)
                         for k, t in self._last_issued.items())
            if recent:
                self.suppressed.append(
                    ("escalation_redundant", now, action, -1, row_id))
                continue
            out.append(((action, -1), a, action))
        return out

    @staticmethod
    def _priority(a: Attribution) -> tuple:
        return (_SEV_RANK.get(a.primary.severity, 0), a.confidence,
                a.primary.score, -a.ts)

    def decide(self, now: float) -> list[Command]:
        """Arbitrate this round's candidates into at most one command per
        (conflict-group, node)."""
        sup0 = len(self.suppressed)
        cmds = self._decide(now)
        tracer = self.tracer
        if tracer is not None:
            for reason, ts, action, node, row in self.suppressed[sup0:]:
                tracer.on_suppressed(reason, ts, action, node, row,
                                     self.trace_source)
            for cmd in cmds:
                tracer.on_command(cmd, self.trace_source)
        return cmds

    def _decide(self, now: float) -> list[Command]:
        if now < self.quarantine_until:
            for a in self._staged:
                self.suppressed.append(
                    ("quarantine", now,
                     BY_ID[a.primary.name].action
                     if a.primary.name in BY_ID else a.primary.name,
                     a.node, a.primary.name))
                self.quarantined += 1
            self._staged.clear()
            return []
        cands = self._candidates(now) + self._due_escalations(now)
        if not cands:
            return []
        best: dict[tuple[str, int], tuple] = {}
        for key, a, action in cands:
            gkey = (CONFLICT_GROUPS.get(action, action), key[1])
            cur = best.get(gkey)
            if cur is None or self._priority(a) > self._priority(cur[1]):
                if cur is not None:
                    self.suppressed.append(
                        ("conflict", now, cur[2], cur[0][1],
                         cur[1].primary.name))
                best[gkey] = (key, a, action)
            else:
                self.suppressed.append(
                    ("conflict", now, action, key[1], a.primary.name))
        cmds: list[Command] = []
        for key, a, action in best.values():
            f = a.primary
            self._next_id += 1
            cmd = Command(
                cmd_id=self._next_id, ts=now, action=action, node=key[1],
                row_id=f.name, locus=a.locus,
                detail={"row": f.name, "locus": a.locus, "score": f.score,
                        "narrative": a.narrative, **f.evidence})
            self._last_issued[key] = now
            self._issue_log.setdefault(key, []).append(now)
            self._pending[key] = 0
            cmds.append(cmd)
        self.issued.extend(cmds)
        return cmds


# CONFLICT_GROUPS ⊆ ACTIONS (the arbitration layer may only group actions
# the controller registry knows about) is enforced statically by
# repro.lint.wiring.check_wiring — the wiring-action rule — gated in CI
# and in tests/test_runbooks.py, replacing the import-time assert that
# used to live here.
