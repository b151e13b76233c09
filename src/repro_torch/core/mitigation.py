"""Closed-loop mitigation controller — the paper's §5 thesis, executable.

    "combining software-based record keeping with DPU-based telemetry can
     create a much [more] efficient closed feedback loop that would allow
     inference clusters to adaptively balance workloads, minimize idle
     bubbles, and deliver predictable low-latency performance at scale."

The controller consumes attributions (``core.attribution``) and issues typed
*actions* against anything implementing ``EngineControls`` — the live JAX
serving engine, the trainer, and the cluster simulator all implement it.
Every runbook row's "Mitigation Directives" column maps to one action key
(``runbooks.RunbookEntry.action``); the ``repro.lint.wiring`` static pass
keeps the two registries in lockstep.  The controller adds per-(action, node)
hysteresis and a cooldown so a single noisy finding doesn't thrash the
engine.

This is the *instant*-mode reference: attribution -> action in the same
call, zero transport latency.  The default closed-loop topology routes
decisions through ``repro.dpu`` instead (``PolicyEngine`` arbitration over
a modeled transport and command bus), which subsumes this hysteresis; the
controller is retained verbatim so instant-mode golden fixtures and the
``control_loop`` benchmark's baseline stay bit-identical to the seed
behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

from repro_torch.core.attribution import Attribution
from repro_torch.core.detectors import Finding
from repro_torch.core.runbooks import BY_ID


class EngineControls(Protocol):
    """Actuation surface the mitigation plane drives.

    Implementations: ``serving.engine.InferenceEngine`` (live),
    ``training.train_loop.Trainer`` (live), ``sim.cluster.ClusterSim`` (sim).
    All methods are best-effort; unknown knobs may no-op, but must return a
    bool saying whether anything changed (for the action log).
    """

    def apply_action(self, action: str, node: int, detail: dict) -> bool: ...


#: action key -> description of what the engine should do (documentation +
#: the closed set tests assert against).
ACTIONS: dict[str, str] = {
    "smooth_admission": "spread request admission over the batching window; "
                        "rate-limit offending clients",
    "rebalance_frontend": "rehash flows across front-end shards / queues",
    "tune_transport": "adjust transport offloads / congestion control",
    "enlarge_egress_buffers": "grow egress buffering; enable zero-copy path",
    "widen_batch_window": "increase decode batching window to absorb jitter",
    "inflight_remap": "remap/pack inflight decode slots onto busy shards "
                      "(load stealing for early-finished sequences)",
    "admission_control": "throttle new request admission until drained",
    "pin_and_coalesce": "pre-pin transfer pools and coalesce small DMAs",
    "batch_launches": "aggregate device launches; enlarge launch queue",
    "rebalance_microbatches": "shift microbatch quota away from slow device",
    "stagger_io": "phase-shift bulk I/O away from compute-critical windows",
    "replace_topology": "prefer direct interconnect path / repin devices",
    "isolate_host_threads": "pin runtime threads; isolate IRQs",
    "rebalance_shards": "resize/reassign TP shards toward slow rank",
    "repartition_stages": "move layers between pipeline stages",
    "reroute_traffic": "enable adaptive routing / spread ranks over links",
    "qos_partition": "partition queues per traffic class (QoS/ECN)",
    "widen_rdma_window": "increase RDMA QP window / credit budget",
    "compress_kv": "enable KV-cache compression for transfers",
    "rebalance_replicas": "redistribute queued requests across DP replicas; "
                          "refresh the router view / break hot affinity",
    "rebalance_nodes": "level queued requests across the nodes inside each "
                       "replica; restore the intra-replica spread",
    "throttle_telemetry": "raise the telemetry tap's sampling stride / shed "
                          "low-priority event classes so the DPU ingest "
                          "budget recovers",
    "shrink_batch": "halve the decode batch-slot cap so the active batch "
                    "drops back below the memory-bandwidth knee",
    "reroute_rail": "spread cross-domain collective legs over all rails "
                    "instead of their home rail (hot-rail bypass)",
    "failover_controller": "fail mitigation over to the degraded host-side "
                           "fallback controller (high-confidence rows only, "
                           "longer confirmations, no cluster-scoped quorum) "
                           "until the DPU path round-trips again",
    "resync_telemetry": "re-register the telemetry tap and resync the "
                        "batch sequence stream after an ingest gap; clears "
                        "the blackout latch once the stream is whole",
    "remirror_standby": "replay the watchdog's retained tap history into "
                        "the lagging standby sidecar and resync its "
                        "sequence stream so its detector state catches "
                        "back up to the primary's",
    "fence_stale_controller": "deliver the currently granted lease term "
                              "to any deposed-but-alive sidecar (quiesce "
                              "it) and purge its outstanding commands; "
                              "the fence itself already blocked the stale "
                              "actuations",
}

# keep the two registries in lockstep: every runbook row must actuate
# through a key the controller (and the DPU policy engine) understands.
# ACTIONS <-> runbook sync (rows only reference registered actions; every
# action is emitted by some row) is enforced statically by
# repro.lint.wiring.check_wiring — the wiring-action rule — gated in CI
# and in tests/test_runbooks.py, replacing the import-time assert that
# used to live here.


@dataclass(frozen=True)
class ActionRecord:
    ts: float
    action: str
    node: int
    row_id: str
    locus: str
    applied: bool
    detail: dict = field(default_factory=dict, compare=False)


class MitigationController:
    """Maps attributions -> engine actions with hysteresis + cooldown."""

    def __init__(self, engine: EngineControls,
                 min_confidence: float = 0.6,
                 confirmations: int = 2,
                 cooldown: float = 5.0) -> None:
        self.engine = engine
        self.min_confidence = min_confidence
        self.confirmations = confirmations
        self.cooldown = cooldown
        self._pending: dict[tuple[str, int], int] = {}
        self._last_applied: dict[tuple[str, int], float] = {}
        self.log: list[ActionRecord] = []

    def consider(self, attribution: Attribution) -> ActionRecord | None:
        f: Finding = attribution.primary
        entry = BY_ID.get(f.name)
        if entry is None or attribution.confidence < self.min_confidence:
            return None
        key = (entry.action, attribution.node)
        # hysteresis: require repeated confirmation before actuating
        hits = self._pending.get(key, 0) + 1
        self._pending[key] = hits
        needed = 1 if f.severity == "critical" else self.confirmations
        if hits < needed:
            return None
        last = self._last_applied.get(key, float("-inf"))
        if attribution.ts - last < self.cooldown:
            return None
        detail = {
            "row": f.name,
            "locus": attribution.locus,
            "score": f.score,
            "narrative": attribution.narrative,
            # instant topology: actuation time IS the attribution time
            # (actuators like ReplicaSet read wall time from here)
            "now": attribution.ts,
            **f.evidence,
        }
        applied = self.engine.apply_action(entry.action, attribution.node,
                                           detail)
        rec = ActionRecord(ts=attribution.ts, action=entry.action,
                           node=attribution.node, row_id=f.name,
                           locus=attribution.locus, applied=applied,
                           detail=detail)
        self.log.append(rec)
        if applied:
            self._last_applied[key] = attribution.ts
            self._pending[key] = 0
        return rec

    def consider_all(self, attributions: list[Attribution]
                     ) -> list[ActionRecord]:
        out = []
        for a in attributions:
            r = self.consider(a)
            if r is not None:
                out.append(r)
        return out


class NullEngine:
    """EngineControls that records but does nothing (detection-only mode)."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, int, dict]] = []

    def apply_action(self, action: str, node: int, detail: dict) -> bool:
        self.calls.append((action, node, detail))
        return True
