"""Executable detectors — one per row of the paper's Tables 3(a), 3(b), 3(c).

Each detector consumes only DPU-observable events (``core.events``), keeps
O(1)-per-key streaming state (``core.sketch``), and yields ``Finding`` records
binding the paper's columns: signal -> lifecycle stage -> root cause ->
mitigation directive.

Detector contract:
    d.interested : frozenset[EventKind]   events it wants
    d.update(ev) : feed one event (line-rate path, must be cheap)
    d.poll(now)  : -> list[Finding]       periodic evaluation (control path)

Thresholds are deliberately self-calibrating (z-scores / CUSUM against learned
baselines) so the same detector works on simulated traces and on the live JAX
serving engine without per-workload tuning.  Absolute capacity thresholds
(link saturation) take the capacity from ``DetectorConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.events import (
    COLL_EDGE_FINISH,
    COLL_GROUP_ALL_GATHER,
    COLL_GROUP_REDUCE_SCATTER,
    CollectiveOp,
    DOMAIN_GROUP_BASE,
    Event,
    EventBatch,
    EventKind,
    RAIL_GROUP_BASE,
)
from repro_torch.core.sketch import (
    EWMA,
    BurstMeter,
    CUSUM,
    GapTracker,
    P2Quantile,
    RateMeter,
    SpreadTracker,
    Welford,
)

# meta-field conventions (documented in events.py docstring-level contract):
META_DIR_INGRESS = 0
META_DIR_EGRESS = 1
META_DIR_EW = 2          # east-west fabric retransmit
META_FIN = 1             # EGRESS_PKT meta flag: final packet of flow
META_P2P_INTRA = 0       # P2P_BURST inside one node (PCIe peer path)
META_P2P_INTER = 1       # P2P_BURST between nodes (PP handoff)
META_P2P_KV = 2          # P2P_BURST carrying KV-cache pages
META_KV_OCC = 3          # QUEUE_SAMPLE carrying KV-occupancy (% of pool)
META_TAP_DEBUG = 4       # QUEUE_SAMPLE from a verbose debug tap (payload
#                          noise for the telemetry plane; no detector keys
#                          on it — it only consumes DPU ingest budget)
META_DPU_RING = 5        # QUEUE_SAMPLE: DPU self-telemetry (ingest-ring
#                          occupancy % in depth, rows shed since the last
#                          sample in size; node = -1)
META_BATCH_OCC = 6       # QUEUE_SAMPLE: scheduler-exported active decode
#                          batch size per node (depth = active slots) — the
#                          NIC-side tap of the host scheduler's slot count,
#                          same vantage as the ingress-queue samples
META_MON_HEARTBEAT = 7   # QUEUE_SAMPLE: host-side watchdog heartbeat probe
#                          (size = 1 while the DPU is silent past the
#                          timeout, 0 while healthy; depth = silence ms;
#                          node = -1) — emitted into the STANDBY plane by
#                          the watchdog, never by the DPU itself
META_MON_INGEST = 8      # QUEUE_SAMPLE: DPU ingest-guard health (size =
#                          missing + corrupt rows latched since the last
#                          resync, depth = replays dropped; node = -1);
#                          emitted only while the guard is dirty
META_MON_BUS = 9         # QUEUE_SAMPLE: command-bus health (size =
#                          cumulative retry exhaustions, depth = cumulative
#                          retries; node = -1); emitted only between an
#                          exhaustion and the next successful ack
META_MON_STANDBY = 10    # QUEUE_SAMPLE: standby-shadow health probe (size =
#                          standby tap-clock lag behind the primary in ms,
#                          clamped at 0 — a dead *primary* is the outage
#                          row's business; depth = 1 while the standby is
#                          up, 0 while crashed; node = -1) — emitted by the
#                          watchdog every probe while a standby exists
META_MON_FENCE = 11      # QUEUE_SAMPLE: stale-term commands fenced by the
#                          host actuator since the last probe (size =
#                          fenced delta, depth = current granted term;
#                          node = -1); emitted only when the delta is > 0
META_MON_RETAIN = 12     # QUEUE_SAMPLE: watchdog retained-tap-window gauge
#                          (size = retained batch count, depth = payload
#                          span covered in ms; node = -1) — emitted every
#                          probe while the window is non-empty, so a
#                          count-cap-starved replay window (and with it a
#                          thin remirror_standby) is observable, not
#                          inferred.  No detector consumes it today.


def _ext_group(group: int) -> bool:
    """True for rows of the per-collective / rail / domain emission tier.

    The aggregate-tier 3c detectors skip these rows: the dedicated 3e rows
    (collective_straggler, rail_congestion) own those signals, and the much
    denser per-op cadence would otherwise poison the gap/spread baselines
    the aggregate detectors learn from the legacy group-0 bursts.
    """
    return (group == COLL_GROUP_ALL_GATHER
            or group == COLL_GROUP_REDUCE_SCATTER
            or group >= RAIL_GROUP_BASE)


@dataclass(frozen=True)
class Finding:
    """One detected pathological condition (a runbook row firing)."""

    name: str              # runbook row id, e.g. "tp_straggler"
    table: str             # "3a" | "3b" | "3c" | "3d"
    ts: float
    severity: str          # "warn" | "critical"
    node: int              # locus node (-1 = cluster-wide)
    device: int            # locus device (-1 = n/a)
    stage: str             # lifecycle stage affected (paper column 3)
    root_cause: str        # likely root cause (paper column 5)
    directive: str         # mitigation directive (paper column 6)
    score: float           # detector-specific magnitude (z-score / ratio)
    evidence: dict = field(default_factory=dict, compare=False)


@dataclass
class DetectorConfig:
    """Shared capacity constants + sensitivity knobs."""

    nic_gbps: float = 200.0          # NIC line rate (bytes/s derived below)
    pcie_gBps: float = 64.0          # PCIe gen5 x16-ish GB/s
    ici_gBps: float = 50.0           # per-link ICI GB/s (TPU v5e)
    saturation_frac: float = 0.90    # "near link capacity"
    z_warn: float = 3.0
    z_crit: float = 6.0
    skew_cv_warn: float = 0.35       # coefficient-of-variation skew threshold
    skew_cv_crit: float = 0.70
    jitter_warn: float = 1.5         # CV of inter-arrival gaps
    jitter_crit: float = 3.0
    starvation_factor: float = 8.0   # open gap vs learned p99 gap
    min_events: int = 32             # warmup before a detector may fire

    @property
    def nic_Bps(self) -> float:
        return self.nic_gbps * 1e9 / 8.0

    @property
    def pcie_Bps(self) -> float:
        return self.pcie_gBps * 1e9

    @property
    def ici_Bps(self) -> float:
        return self.ici_gBps * 1e9


class Detector:
    """Base class; subclasses fill the paper-row metadata and the logic."""

    name: str = "abstract"
    table: str = "?"
    stage: str = "?"
    root_cause: str = "?"
    directive: str = "?"
    interested: frozenset = frozenset()

    def __init__(self, cfg: DetectorConfig) -> None:
        self.cfg = cfg
        self.events_seen = 0

    def update(self, ev: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def update_batch(self, batch: EventBatch) -> None:
        """Feed one columnar batch (already filtered to ``interested`` kinds).

        Subclasses on the per-packet-dominant rows override this with
        vectorized implementations that are bit-identical to the scalar
        path (the batch/scalar equivalence property test enforces it);
        this default replays the batch through ``update`` — correct for
        every detector, just not fast.

        Contract for overriders: the dispatcher may deliver any
        kind-partition of the wire order (e.g. one sub-batch per event
        kind), so a vectorized implementation must process each kind class
        independently — it may not depend on cross-kind interleaving.
        Detectors that pair events across kinds (dispatch->D2H latency and
        friends) must NOT override this; the scalar fallback preserves full
        wire order for them.
        """
        for ev in batch.iter_events():
            self.update(ev)

    def poll(self, now: float) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def _mk(self, now: float, score: float, node: int = -1, device: int = -1,
            severity: str | None = None, **evidence) -> Finding:
        sev = severity or ("critical" if score >= self.cfg.z_crit else "warn")
        return Finding(
            name=self.name, table=self.table, ts=now, severity=sev,
            node=node, device=device, stage=self.stage,
            root_cause=self.root_cause, directive=self.directive,
            score=score, evidence=evidence,
        )


# ======================================================================
# Table 3(a) — North-South runbook
# ======================================================================


class BurstAdmissionBacklog(Detector):
    """3a.1 — sudden ingress spikes followed by queueing delay."""

    name = "burst_admission_backlog"
    table = "3a"
    stage = "ingress (prefill/start)"
    root_cause = "load spike from clients / front-end batching / NIC queue limits"
    directive = "smooth input batching; rate-limit clients; increase NIC queue depth"
    interested = frozenset({EventKind.INGRESS_PKT, EventKind.QUEUE_SAMPLE})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.burst = BurstMeter()
        self.queue = EWMA(0.05)
        # bursts are much shorter than the poll interval: latch the peaks
        # seen since the last poll (a DPU would export max-over-interval)
        self.peak_burst = 0.0
        self.peak_depth = 0

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.INGRESS_PKT:
            self.burst.update(ev.ts, ev.size)
            self.peak_burst = max(self.peak_burst,
                                  self.burst.byte_burstiness())
        elif ev.kind == EventKind.QUEUE_SAMPLE and ev.meta == META_DIR_INGRESS:
            self.peak_depth = max(self.peak_depth, ev.depth)
            self.queue.update(float(ev.depth))

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        kinds = batch.kind
        ing = kinds == EventKind.INGRESS_PKT
        if ing.any():
            # the peak latch samples burstiness after every meter step, so
            # the fold is sequential; both rate meters are inlined (same
            # float ops as RateMeter.update — bit-identical)
            fast, slow = self.burst.fast, self.burst.slow
            f_hl, s_hl = fast.halflife, slow.halflife
            f_last, f_rate, f_brate = fast._last_ts, fast._rate, fast._brate
            s_last, s_rate, s_brate = slow._last_ts, slow._rate, slow._brate
            peak = self.peak_burst
            for ts, sz in zip(batch.ts[ing].tolist(),
                              batch.size[ing].tolist()):
                if f_last is None:
                    f_last, f_rate, f_brate = ts, 0.0, 0.0
                    s_last, s_rate, s_brate = ts, 0.0, 0.0
                else:
                    dt = ts - f_last
                    if dt < 1e-9:
                        dt = 1e-9
                    decay = 0.5 ** (dt / f_hl)
                    one_m = 1.0 - decay
                    f_rate = f_rate * decay + one_m / dt
                    f_brate = f_brate * decay + one_m * sz / dt
                    f_last = ts
                    dt = ts - s_last
                    if dt < 1e-9:
                        dt = 1e-9
                    decay = 0.5 ** (dt / s_hl)
                    one_m = 1.0 - decay
                    s_rate = s_rate * decay + one_m / dt
                    s_brate = s_brate * decay + one_m * sz / dt
                    s_last = ts
                if s_brate > 1e-9:
                    b = f_brate / s_brate
                    if b > peak:
                        peak = b
            fast._last_ts, fast._rate, fast._brate = f_last, f_rate, f_brate
            slow._last_ts, slow._rate, slow._brate = s_last, s_rate, s_brate
            self.peak_burst = peak
        qs = (kinds == EventKind.QUEUE_SAMPLE) & (batch.meta
                                                  == META_DIR_INGRESS)
        if qs.any():
            depths = batch.depth[qs]
            d = int(depths.max())
            if d > self.peak_depth:
                self.peak_depth = d
            self.queue.update_many(depths.astype(np.float64).tolist())

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        b, depth = self.peak_burst, self.peak_depth
        self.peak_burst, self.peak_depth = 0.0, 0
        qz = self.queue.zscore(float(depth))
        # burst alone is normal traffic; burst + REAL backlog is the
        # pathology (absolute depth floor rejects transient 1-2 deep queues)
        if b > 4.0 and qz > self.cfg.z_warn and depth >= 24:
            return [self._mk(now, score=qz, burstiness=b, queue_depth=depth)]
        return []


class IngressStarvation(Detector):
    """3a.2 — long gaps between ingress packets for some flows."""

    name = "ingress_starvation"
    table = "3a"
    stage = "ingress -> PCIe feed"
    root_cause = "upstream service jitter / uneven client distribution"
    directive = "balance load-balancer hashing; check NIC RSS/flow steering"
    interested = frozenset({EventKind.INGRESS_PKT})

    # freeze the p99-gap reference after warmup: a slow drift toward
    # starvation must not teach the tracker that long gaps are normal,
    # and steady-state ingress stops paying the quantile sketch
    P99_FREEZE = 512

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.per_node: dict[int, GapTracker] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        self.per_node.setdefault(
            ev.node, GapTracker(p99_cap=self.P99_FREEZE)).update(ev.ts)

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        buckets: dict[int, list[float]] = {}
        for node, ts in zip(batch.node.tolist(), batch.ts.tolist()):
            b = buckets.get(node)
            if b is None:
                buckets[node] = [ts]
            else:
                b.append(ts)
        per_node = self.per_node
        for node, tss in buckets.items():
            gt = per_node.get(node)
            if gt is None:
                gt = per_node[node] = GapTracker(p99_cap=self.P99_FREEZE)
            gt.update_many(tss)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, gt in self.per_node.items():
            base = max(gt.p99.value, 1e-6)
            open_gap = gt.current_gap(now)
            if gt.gaps.n >= 16 and open_gap > self.cfg.starvation_factor * base:
                out.append(self._mk(now, score=open_gap / base, node=node,
                                    open_gap=open_gap, p99_gap=base))
        return out


class FlowSkewAcrossSessions(Detector):
    """3a.3 — some ingress flows high-volume, others sparse."""

    name = "flow_skew_across_sessions"
    table = "3a"
    stage = "ingress (per-request)"
    root_cause = "session-affinity mismatch / QUIC stream imbalance"
    directive = "verify flow hashing; rebalance RPC streams"
    interested = frozenset({EventKind.INGRESS_PKT})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.flow_bytes: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.flow >= 0:
            self.flow_bytes[ev.flow] = self.flow_bytes.get(ev.flow, 0) + ev.size

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        flows = batch.flow
        m = flows >= 0
        if not m.any():
            return
        fb = self.flow_bytes
        get = fb.get
        for f, s in zip(flows[m].tolist(), batch.size[m].tolist()):
            fb[f] = get(f, 0) + s

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or len(self.flow_bytes) < 4:
            return []
        w = Welford()
        for v in self.flow_bytes.values():
            w.update(float(v))
        cv = w.cv()
        if cv > self.cfg.skew_cv_crit:
            sev = "critical" if cv > 2 * self.cfg.skew_cv_crit else "warn"
            return [self._mk(now, score=cv, severity=sev, cv=cv,
                             n_flows=len(self.flow_bytes))]
        return []


class _RetransmitBase(Detector):
    """Shared logic for retransmit-rate rows (3a.4, 3a.7, 3c.6).

    Fires when the retransmit count exceeds a few percent of the matching
    traffic class's count over the recent window — the denominator is the
    traffic class the retransmits belong to, not the whole event stream.
    Both counters halve at every poll (exponential forgetting), the classic
    DPU counter idiom: two integer adds per event on the line-rate path, a
    division only on the control path.
    """

    direction = META_DIR_INGRESS
    traffic_kind = EventKind.INGRESS_PKT
    interested = frozenset({EventKind.RETRANSMIT, EventKind.INGRESS_PKT,
                            EventKind.EGRESS_PKT, EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.retx_win = 0        # retransmits in the decaying window
        self.traffic_win = 0     # matching traffic in the window
        self.retrans = 0         # all-time retransmits (absolute floor)
        self.retrans_nodes: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.RETRANSMIT and ev.meta == self.direction:
            self.retrans += 1
            self.retx_win += 1
            self.retrans_nodes[ev.node] = self.retrans_nodes.get(ev.node, 0) + 1
        elif ev.kind == self.traffic_kind:
            self.traffic_win += 1

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        kinds = batch.kind
        retx = (kinds == EventKind.RETRANSMIT) & (batch.meta
                                                  == self.direction)
        if retx.any():
            nodes = batch.node[retx].tolist()
            rn = self.retrans_nodes
            get = rn.get
            for node in nodes:
                rn[node] = get(node, 0) + 1
            self.retrans += len(nodes)
            self.retx_win += len(nodes)
        self.traffic_win += int((kinds == self.traffic_kind).sum())

    def poll(self, now: float) -> list[Finding]:
        retx_w = self.retx_win
        traffic_w = self.traffic_win
        # exponential forgetting on EVERY poll, including warmup/quiet ones:
        # a late-onset fault must be judged against the recent window, not
        # diluted by the whole undecayed healthy history
        self.retx_win //= 2
        self.traffic_win //= 2
        if self.events_seen < self.cfg.min_events or self.retrans < 8:
            return []
        ratio = retx_w / max(traffic_w, 1)
        if ratio > 0.02 and retx_w >= 4:
            node = max(self.retrans_nodes, key=self.retrans_nodes.__getitem__,
                       default=-1)
            sev = "critical" if ratio > 0.10 else "warn"
            return [self._mk(now, score=ratio * 100, node=node, severity=sev,
                             retransmit_ratio=ratio,
                             retransmits=self.retrans)]
        return []


class IngressDropRetransmit(_RetransmitBase):
    """3a.4 — missing/retransmitted initial packets."""

    name = "ingress_drop_retransmit"
    table = "3a"
    stage = "ingress (request birth)"
    root_cause = "congestion / MTU mismatch / link errors"
    directive = "enable NIC offloads (TSO/GRO); verify MTU; check cabling"
    direction = META_DIR_INGRESS
    traffic_kind = EventKind.INGRESS_PKT


class EgressBacklogQueueing(Detector):
    """3a.5 — responses accumulate in NIC queues before send."""

    name = "egress_backlog_queueing"
    table = "3a"
    stage = "egress (response flush)"
    root_cause = "CPU copy bottleneck / NIC buffer exhaustion"
    directive = "offload checksums; zero-copy send; increase NIC buffers"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.per_node: dict[int, CUSUM] = {}
        self.depths: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_DIR_EGRESS:
            return
        self.events_seen += 1
        self.per_node.setdefault(ev.node, CUSUM(threshold=4.0)).update(
            float(ev.depth))
        self.depths[ev.node] = ev.depth

    def update_batch(self, batch: EventBatch) -> None:
        m = (batch.kind == EventKind.QUEUE_SAMPLE) & (batch.meta
                                                      == META_DIR_EGRESS)
        cnt = int(m.sum())
        if cnt == 0:
            return
        self.events_seen += cnt
        per_node = self.per_node
        depths = self.depths
        for node, dep in zip(batch.node[m].tolist(), batch.depth[m].tolist()):
            cs = per_node.get(node)
            if cs is None:
                cs = per_node[node] = CUSUM(threshold=4.0)
            cs.update(float(dep))
            depths[node] = dep

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, cs in self.per_node.items():
            if cs.stat > cs.threshold:
                out.append(self._mk(now, score=cs.stat, node=node,
                                    queue_depth=self.depths.get(node, 0)))
        return out


class EgressJitter(Detector):
    """3a.6 — outgoing packets for a token stream spread unevenly."""

    name = "egress_jitter"
    table = "3a"
    stage = "egress (decode outputs)"
    root_cause = "scheduler variance / CPU<->NIC contention"
    directive = "isolate runtime threads; pin NIC IRQs; widen batching window"
    interested = frozenset({EventKind.EGRESS_PKT})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # jitter is CV-of-gaps; the p99 sketch is never read, so don't pay
        # for it on the hottest per-flow path in the plane
        self.per_flow: dict[int, GapTracker] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        self.per_flow.setdefault(
            ev.flow, GapTracker(track_p99=False)).update(ev.ts)

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        buckets: dict[int, list[float]] = {}
        for f, ts in zip(batch.flow.tolist(), batch.ts.tolist()):
            b = buckets.get(f)
            if b is None:
                buckets[f] = [ts]
            else:
                b.append(ts)
        per_flow = self.per_flow
        for f, tss in buckets.items():
            gt = per_flow.get(f)
            if gt is None:
                gt = per_flow[f] = GapTracker(track_p99=False)
            gt.update_many(tss)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        jittery, n = [], 0
        for flow, gt in self.per_flow.items():
            if gt.gaps.n < 16:
                continue
            n += 1
            j = gt.jitter()
            if j > 1.2 * self.cfg.jitter_warn:
                jittery.append((flow, j))
        if n > 0 and len(jittery) >= max(1, n // 4):
            worst = max(j for _, j in jittery)
            return [self._mk(now, score=worst, jittery_flows=len(jittery),
                             flows_measured=n)]
        return []


class EgressDropRetransmit(_RetransmitBase):
    """3a.7 — retransmissions/gaps in final response streams."""

    name = "egress_drop_retransmit"
    table = "3a"
    stage = "egress"
    root_cause = "NIC offload misconfig / fabric congestion / buffer underrun"
    directive = "check offload settings; enable congestion control (ECN/PFC)"
    direction = META_DIR_EGRESS
    traffic_kind = EventKind.EGRESS_PKT


class EarlyCompletionSkew(Detector):
    """3a.8 — some egress flows terminate far earlier than peers."""

    name = "early_completion_skew"
    table = "3a"
    stage = "egress (multi-stream decode)"
    root_cause = "early-stop on short sequences; no remap of freed resources"
    directive = "enable inflight remapping / load stealing for decode"
    interested = frozenset({EventKind.EGRESS_PKT})

    WINDOW = 0.05           # seconds per activity window
    DECAY_WINDOWS = 6       # consecutive low windows before firing
    LOW_FRAC = 0.5          # "low" = active flows < this fraction of peak

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # per group: (window_start, flows_this_window, peak, low_streak)
        self.state: dict[int, list] = {}
        self.pending: dict[int, tuple[float, int, int]] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        st = self.state.get(ev.group)
        if st is None:
            # [window_start, flows, decayed_peak, low_streak, abs_peak]
            st = [ev.ts, set(), 0.0, 0, 0]
            self.state[ev.group] = st
        if ev.ts - st[0] >= self.WINDOW:
            n = len(st[1])
            if n > 0:
                # a healthy engine keeps slots refilled: the number of
                # distinct streaming flows per window stays near its peak.
                # Early-completion skew shows as a *sustained* decay while
                # the group keeps emitting.
                st[2] = max(st[2] * 0.995, float(n))
                st[4] = max(st[4], n)
                if n < self.LOW_FRAC * st[2] and st[4] >= 4:
                    st[3] += 1
                else:
                    st[3] = 0
                if st[3] >= self.DECAY_WINDOWS:
                    self.pending[ev.group] = (ev.ts, n, st[4])
            st[0] = ev.ts
            st[1] = set()
        st[1].add(ev.flow)

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        state = self.state
        pending = self.pending
        window = self.WINDOW
        low = self.LOW_FRAC
        decay_windows = self.DECAY_WINDOWS
        for g, ts, f in zip(batch.group.tolist(), batch.ts.tolist(),
                            batch.flow.tolist()):
            st = state.get(g)
            if st is None:
                st = state[g] = [ts, set(), 0.0, 0, 0]
            if ts - st[0] >= window:
                n = len(st[1])
                if n > 0:
                    st[2] = max(st[2] * 0.995, float(n))
                    if n > st[4]:
                        st[4] = n
                    if n < low * st[2] and st[4] >= 4:
                        st[3] += 1
                    else:
                        st[3] = 0
                    if st[3] >= decay_windows:
                        pending[g] = (ts, n, st[4])
                st[0] = ts
                st[1] = set()
            st[1].add(f)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or not self.pending:
            return []
        out = []
        for g, (ts, n, peak) in self.pending.items():
            done_frac = 1.0 - n / max(peak, 1)
            out.append(self._mk(
                now, score=done_frac * 10, node=-1,
                severity="critical" if done_frac >= 0.7 else "warn",
                group=g, active_flows=n, peak_flows=peak,
                done_frac=done_frac))
        self.pending.clear()
        return out


class BandwidthSaturation(Detector):
    """3a.9 — NIC RX/TX at or near link capacity with queue buildup."""

    name = "ingress_egress_bandwidth_saturation"
    table = "3a"
    stage = "ingress + egress"
    root_cause = "shared NIC with storage/other jobs; insufficient link"
    directive = "upgrade NIC; QoS partitioning; stagger workloads"
    interested = frozenset({EventKind.INGRESS_PKT, EventKind.EGRESS_PKT,
                            EventKind.QUEUE_SAMPLE})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # NIC-style byte counters: utilization = counter delta / interval.
        # (Robust to interleaved event classes, unlike instantaneous rates.)
        self.bytes: dict[int, int] = {}
        self.depth: dict[int, int] = {}
        self.last_poll: float | None = None

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.QUEUE_SAMPLE:
            self.depth[ev.node] = max(self.depth.get(ev.node, 0), ev.depth)
        else:
            self.bytes[ev.node] = self.bytes.get(ev.node, 0) + ev.size

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        qs = batch.kind == EventKind.QUEUE_SAMPLE
        if qs.any():
            depth = self.depth
            get = depth.get
            nodes = batch.node[qs]
            depths = batch.depth[qs]
            for node in np.unique(nodes).tolist():
                dep = int(depths[nodes == node].max())
                cur = get(node, 0)
                depth[node] = dep if dep > cur else cur
        rest = ~qs
        if rest.any():
            byts = self.bytes
            get = byts.get
            nodes = batch.node[rest]
            sizes = batch.size[rest]
            # per-node int64 sums: exact (integer accumulator), and the
            # poll below iterates nodes in sorted order so the dict's
            # insertion order cannot diverge between scalar and batch paths
            for node in np.unique(nodes).tolist():
                byts[node] = get(node, 0) + int(sizes[nodes == node].sum())

    def poll(self, now: float) -> list[Finding]:
        out: list[Finding] = []
        if self.last_poll is not None and now > self.last_poll:
            dt = now - self.last_poll
            if self.events_seen >= self.cfg.min_events:
                for node, nbytes in sorted(self.bytes.items()):
                    frac = nbytes / dt / self.cfg.nic_Bps
                    if (frac > self.cfg.saturation_frac
                            and self.depth.get(node, 0) > 0):
                        out.append(self._mk(
                            now, score=frac * 10, node=node,
                            severity="critical" if frac > 1.0 else "warn",
                            link_utilization=frac,
                            queue_depth=self.depth.get(node, 0)))
        self.last_poll = now
        self.bytes.clear()
        self.depth.clear()
        return out


# ======================================================================
# Table 3(b) — PCIe observer runbook
# ======================================================================


class H2DDataStarvation(Detector):
    """3b.1 — clustered H2D DMAs then long gaps before dispatches."""

    name = "h2d_data_starvation"
    table = "3b"
    stage = "ingress -> PCIe (prefill & decode input feed)"
    root_cause = "PCIe BW cap / NUMA miss / pageable (unpinned) host buffers"
    directive = "pin memory; bind NUMA socket; verify PCIe link width/speed"
    interested = frozenset({EventKind.H2D_XFER, EventKind.INGRESS_PKT})

    REF_SAMPLES = 256    # freeze the healthy gap reference after this many

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.h2d_gap: dict[tuple[int, int], GapTracker] = {}
        self.ref: dict[tuple[int, int], float] = {}
        self.ingress_live: dict[int, float] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.INGRESS_PKT:
            self.ingress_live[ev.node] = ev.ts
        else:
            key = (ev.node, ev.device)
            # p99 is only read until the healthy reference freezes; cap the
            # quantile sketch there so steady-state DMAs stop paying for it
            gt = self.h2d_gap.setdefault(
                key, GapTracker(p99_cap=self.REF_SAMPLES))
            gt.update(ev.ts)
            if gt.gaps.n == self.REF_SAMPLES:
                # freeze a healthy reference so a sustained stall can't
                # teach the tracker that stalls are normal
                self.ref[key] = max(gt.p99.value, 1e-6)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for (node, dev), gt in self.h2d_gap.items():
            if gt.gaps.n < 16:
                continue
            base = self.ref.get((node, dev), max(gt.p99.value, 1e-6))
            gap = max(gt.current_gap(now), gt.gaps.mean)
            # "recent" on the ingress timescale (requests are sparser than
            # per-step DMAs), not the H2D timescale
            ingress_recent = now - self.ingress_live.get(node, -1e9) < 0.25
            # starving: requests keep arriving but the device feed went quiet
            if ingress_recent and gap > self.cfg.starvation_factor * base:
                out.append(self._mk(now, score=gap / base, node=node,
                                    device=dev, open_gap=gap, p99_gap=base))
        return out


class D2HReturnBottleneck(Detector):
    """3b.2 — D2H DMAs linger; backlog after dispatches."""

    name = "d2h_return_bottleneck"
    table = "3b"
    stage = "egress (logits/tokens back to host)"
    root_cause = "PCIe saturation / IOMMU contention / CPU copy hotspots"
    directive = "large pinned buffers; reduce copies; check IOMMU/ATS"
    interested = frozenset({EventKind.DISPATCH, EventKind.D2H_XFER})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # dispatch->return latency per device
        self.pending: dict[tuple[int, int], list[float]] = {}
        self.lat: dict[tuple[int, int], CUSUM] = {}
        self.last_lat: dict[tuple[int, int], float] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        key = (ev.node, ev.device)
        if ev.kind == EventKind.DISPATCH:
            q = self.pending.setdefault(key, [])
            q.append(ev.ts)
            if len(q) > 64:           # bounded state (DPU constraint)
                del q[:32]
        else:
            q = self.pending.get(key)
            if q:
                lat = ev.ts - q.pop(0)
                self.last_lat[key] = lat
                self.lat.setdefault(
                    key, CUSUM(threshold=6.0, rel_slack=0.2)).update(lat)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for key, cs in self.lat.items():
            backlog = len(self.pending.get(key, []))
            if cs.stat > cs.threshold:
                out.append(self._mk(
                    now, score=cs.stat, node=key[0], device=key[1],
                    severity="critical" if backlog > 2 else "warn",
                    backlog=backlog,
                    last_latency=self.last_lat.get(key, 0.0)))
                cs.stat *= 0.5   # hysteresis: decay after reporting
        return out


class KernelLaunchLatency(Detector):
    """3b.3 — sporadic doorbells; idle gaps between H2D and next launch."""

    name = "kernel_launch_control_latency"
    table = "3b"
    stage = "compute (device underutilized across prefill/decode)"
    root_cause = "runtime overhead / CPU scheduler delays / too many tiny kernels"
    directive = "batch ops; fuse kernels; raise launch queues; isolate CPU cores"
    interested = frozenset({EventKind.DISPATCH, EventKind.H2D_XFER})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.dispatch_gap: dict[tuple[int, int], GapTracker] = {}
        self.h2d_last: dict[tuple[int, int], float] = {}
        self.h2d_to_dispatch: dict[tuple[int, int], EWMA] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        key = (ev.node, ev.device)
        if ev.kind == EventKind.H2D_XFER:
            self.h2d_last[key] = ev.ts
        else:
            self.dispatch_gap.setdefault(
                key, GapTracker(track_p99=False)).update(ev.ts)
            if key in self.h2d_last:
                self.h2d_to_dispatch.setdefault(key, EWMA(0.05)).update(
                    ev.ts - self.h2d_last[key])

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for key, gt in self.dispatch_gap.items():
            lag = self.h2d_to_dispatch.get(key)
            if gt.gaps.n < 16 or lag is None or lag.n < 8:
                continue
            # data arrived but launches are late & irregular
            z = lag.zscore(lag.mean + lag.std * 0)  # stable baseline measure
            if gt.jitter() > self.cfg.jitter_crit and lag.mean > 4 * max(
                    gt.gaps.mean, 1e-9):
                out.append(self._mk(now, score=gt.jitter(), node=key[0],
                                    device=key[1], dispatch_jitter=gt.jitter(),
                                    h2d_to_dispatch=lag.mean))
        return out


class IntraNodeGpuSkew(Detector):
    """3b.4 — one device shows thin/irregular DMA while peers are steady."""

    name = "intra_node_gpu_skew"
    table = "3b"
    stage = "compute (per-layer) -> propagates to internode"
    root_cause = "uneven microbatching / memory pressure on a single device"
    directive = "rebalance microbatches; unify stream priorities; check clocks"
    interested = frozenset({EventKind.H2D_XFER, EventKind.D2H_XFER})

    HALFLIFE = 1.0       # decay of per-device byte counters (seconds);
                         # long enough that Poisson prefill-placement noise
                         # averages out (~75 prefills/node per halflife)
    PERSIST = 4          # consecutive skewed polls before firing

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # node -> dev -> (decayed_bytes, last_ts)
        self.bytes: dict[int, dict[int, list[float]]] = {}
        self.streak: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        devs = self.bytes.setdefault(ev.node, {})
        cell = devs.get(ev.device)
        if cell is None:
            devs[ev.device] = [float(ev.size), ev.ts]
        else:
            decay = 0.5 ** ((ev.ts - cell[1]) / self.HALFLIFE)
            cell[0] = cell[0] * decay + ev.size
            cell[1] = ev.ts

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, devs in self.bytes.items():
            if len(devs) < 2:
                continue
            w = Welford()
            vals = {}
            for dev, (v, ts) in devs.items():
                decayed = v * 0.5 ** ((now - ts) / self.HALFLIFE)
                vals[dev] = decayed
                w.update(decayed)
            cv = w.cv()
            if cv > self.cfg.skew_cv_warn:
                self.streak[node] = self.streak.get(node, 0) + 1
            else:
                self.streak[node] = 0
            # transient skew (a prefill burst landing on one device) washes
            # out; persistent skew across polls is the pathology
            if self.streak[node] >= self.PERSIST:
                lagger = min(vals, key=vals.__getitem__)
                sev = "critical" if cv > self.cfg.skew_cv_crit else "warn"
                out.append(self._mk(now, score=cv * 10, node=node,
                                    device=lagger, severity=sev, cv=cv))
        return out


class PCIeLinkSaturation(Detector):
    """3b.5 — sustained near-peak PCIe throughput; periodic compute stalls."""

    name = "pcie_link_saturation"
    table = "3b"
    stage = "ingress -> PCIe, egress"
    root_cause = "oversubscribed PCIe switch / x8 link / competing DMAs"
    directive = "verify x16 lanes; move devices off shared switch; stagger I/O"
    interested = frozenset({EventKind.H2D_XFER, EventKind.D2H_XFER})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.bytes: dict[int, int] = {}
        self.sustained: dict[int, int] = {}
        self.last_poll: float | None = None

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        self.bytes[ev.node] = self.bytes.get(ev.node, 0) + ev.size

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        byts = self.bytes
        get = byts.get
        nodes = batch.node
        sizes = batch.size
        for node in np.unique(nodes).tolist():
            byts[node] = get(node, 0) + int(sizes[nodes == node].sum())

    def poll(self, now: float) -> list[Finding]:
        out: list[Finding] = []
        if self.last_poll is not None and now > self.last_poll:
            dt = now - self.last_poll
            if self.events_seen >= self.cfg.min_events:
                for node, nbytes in sorted(self.bytes.items()):
                    frac = nbytes / dt / self.cfg.pcie_Bps
                    if frac > self.cfg.saturation_frac:
                        self.sustained[node] = self.sustained.get(node, 0) + 1
                    else:
                        self.sustained[node] = 0
                    if self.sustained.get(node, 0) >= 3:  # sustained polls
                        out.append(self._mk(now, score=frac * 10, node=node,
                                            link_utilization=frac))
        self.last_poll = now
        self.bytes.clear()
        return out


class GpuP2PThrottling(Detector):
    """3b.6 — intra-node P2P DMAs slow/variable (no NVLink path)."""

    name = "gpu_p2p_throttling"
    table = "3b"
    stage = "compute (intra-box TP/PP)"
    root_cause = "shared uplink on PCIe switch; ACS/ATS settings"
    directive = "prefer NVLink/NVSwitch; same-switch placement; tune ACS/ATS"
    interested = frozenset({EventKind.P2P_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # effective bandwidth per burst: size / duration(meta-encoded?) — the
        # sim reports burst durations via paired events; here we use the gap
        # between same-flow bursts vs size as a throughput proxy.
        self.tput: dict[int, EWMA] = {}
        self.last: dict[tuple[int, int], float] = {}
        self.baseline = EWMA(0.02)

    def update(self, ev: Event) -> None:
        if ev.meta != META_P2P_INTRA:
            return
        self.events_seen += 1
        key = (ev.node, ev.flow)
        if key in self.last:
            dt = max(ev.ts - self.last[key], 1e-9)
            tput = ev.size / dt
            self.tput.setdefault(ev.node, EWMA(0.1)).update(tput)
            self.baseline.update(tput)
        self.last[key] = ev.ts

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or self.baseline.n < 16:
            return []
        out = []
        for node, ew in self.tput.items():
            if ew.n < 8:
                continue
            # a node sustaining < half the cluster-median p2p throughput
            if ew.mean < 0.5 * self.baseline.mean:
                ratio = self.baseline.mean / max(ew.mean, 1e-9)
                out.append(self._mk(now, score=ratio, node=node,
                                    node_tput=ew.mean,
                                    cluster_tput=self.baseline.mean))
        return out


class PinnedMemoryShortage(Detector):
    """3b.7 — many small DMAs instead of large coalesced ones."""

    name = "pinned_memory_shortage"
    table = "3b"
    stage = "ingress -> PCIe (feed) and egress (returns)"
    root_cause = "insufficient pinned pools; fallback to pageable buffers"
    directive = "pre-allocate larger pinned pools; coalesce transfers"
    interested = frozenset({EventKind.H2D_XFER, EventKind.D2H_XFER})

    LOG_SHRINK = 1.5   # fire when mean log-size drops this much (~4.5x)

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # log-domain size tracking: the median-ish typical DMA size is what
        # matters; log-mean is robust to the huge prefill-vs-decode spread
        self.logsize: dict[int, EWMA] = {}
        self.ref: dict[int, float] = {}
        self.rate: dict[int, RateMeter] = {}

    def update(self, ev: Event) -> None:
        import math as _m
        self.events_seen += 1
        ew = self.logsize.setdefault(ev.node, EWMA(0.02))
        ew.update(_m.log(max(ev.size, 1)))
        if ew.n == 256:  # freeze a healthy-size reference after warmup
            self.ref[ev.node] = ew.mean
        self.rate.setdefault(ev.node, RateMeter(halflife=0.1)).update(ev.ts)

    def poll(self, now: float) -> list[Finding]:
        import math as _m
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, ew in self.logsize.items():
            ref = self.ref.get(node)
            if ref is None:
                continue
            drop = ref - ew.mean
            if drop > self.LOG_SHRINK:
                out.append(self._mk(
                    now, score=drop,
                    severity="critical" if drop > 2.5 else "warn",
                    node=node, typical_bytes=_m.exp(ew.mean),
                    baseline_bytes=_m.exp(ref),
                    dma_rate=self.rate[node].rate))
        return out


class HostCpuBottleneck(Detector):
    """3b.8 — low DMA rate despite available PCIe bandwidth; late doorbells."""

    name = "host_cpu_bottleneck"
    table = "3b"
    stage = "compute orchestration"
    root_cause = "CPU contention / IRQ affinity / polling disabled"
    directive = "isolate IRQs/threads; busy-poll; pin runtime threads"
    interested = frozenset({EventKind.H2D_XFER, EventKind.DISPATCH,
                            EventKind.INGRESS_PKT})

    REF_SAMPLES = 256

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.dma_bytes: dict[int, int] = {}
        self.dma_base: dict[int, EWMA] = {}
        self.disp_gap: dict[int, GapTracker] = {}
        self.disp_ref: dict[int, float] = {}
        self.last_poll: float | None = None

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.H2D_XFER:
            self.dma_bytes[ev.node] = self.dma_bytes.get(ev.node, 0) + ev.size
        elif ev.kind == EventKind.DISPATCH:
            gt = self.disp_gap.setdefault(
                ev.node, GapTracker(p99_cap=self.REF_SAMPLES))
            gt.update(ev.ts)
            if gt.gaps.n == self.REF_SAMPLES:
                self.disp_ref[ev.node] = max(gt.p99.value, 1e-6)

    def poll(self, now: float) -> list[Finding]:
        out: list[Finding] = []
        if self.last_poll is not None and now > self.last_poll:
            dt = now - self.last_poll
            for node, nbytes in self.dma_bytes.items():
                cur = nbytes / dt
                base = self.dma_base.setdefault(node, EWMA(0.2))
                gt = self.disp_gap.get(node)
                sagging = base.n >= 2 and cur < 0.4 * base.mean
                if (sagging and self.events_seen >= self.cfg.min_events
                        and gt is not None and gt.gaps.n > 8):
                    pcie_headroom = cur < 0.3 * self.cfg.pcie_Bps
                    ref = self.disp_ref.get(node, max(gt.p99.value, 1e-6))
                    starved_dispatch = (
                        max(gt.current_gap(now), gt.gaps.mean) > 3 * ref)
                    if pcie_headroom and starved_dispatch:
                        score = base.mean / max(cur, 1e-9)
                        out.append(self._mk(
                            now, score=min(score, 100.0), node=node,
                            dma_byte_rate=cur, baseline=base.mean))
                if base.n < 2 or not sagging:
                    # never learn the baseline from a sagging window — the
                    # pathology must not poison its own reference
                    base.update(cur)
        self.last_poll = now
        self.dma_bytes.clear()
        return out


class MemoryRegistrationChurn(Detector):
    """3b.9 — frequent map/unmap patterns around DMAs."""

    name = "memory_registration_churn"
    table = "3b"
    stage = "ingress -> PCIe"
    root_cause = "repeated registration of short-lived buffers"
    directive = "reuse registered buffers; GPUDirect with persistent MR"
    interested = frozenset({EventKind.MEM_REG, EventKind.H2D_XFER,
                            EventKind.D2H_XFER})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.reg: dict[int, int] = {}
        self.dma: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.MEM_REG:
            self.reg[ev.node] = self.reg.get(ev.node, 0) + 1
        else:
            self.dma[ev.node] = self.dma.get(ev.node, 0) + 1

    def update_batch(self, batch: EventBatch) -> None:
        self.events_seen += len(batch)
        reg = batch.kind == EventKind.MEM_REG
        for target, m in ((self.reg, reg), (self.dma, ~reg)):
            if m.any():
                get = target.get
                for node in batch.node[m].tolist():
                    target[node] = get(node, 0) + 1

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, regs in list(self.reg.items()):
            dmas = self.dma.get(node, 0)
            if dmas < 16:
                continue
            ratio = regs / dmas
            if ratio > 0.5:  # healthy runtimes register once, DMA many times
                out.append(self._mk(
                    now, score=ratio * 10, node=node,
                    severity="critical" if ratio > 1.0 else "warn",
                    reg_per_dma=ratio, registrations=regs, dmas=dmas))
            # exponential forgetting: judge recent windows, not all history
            self.reg[node] = regs // 2
            self.dma[node] = dmas // 2
        return out


class DecodeEarlyStopSkew(Detector):
    """3b.10 — D2H drops off early on some streams/devices."""

    name = "decode_early_stop_skew"
    table = "3b"
    stage = "compute (decode) -> egress"
    root_cause = "sequence-length variance; scheduler not rebalancing"
    directive = "inflight request remapping/packing; speculative decode policies"
    interested = frozenset({EventKind.D2H_XFER})

    REF_SAMPLES = 128

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.last: dict[tuple[int, int], float] = {}
        self.gap: dict[tuple[int, int], GapTracker] = {}
        self.ref: dict[tuple[int, int], float] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        key = (ev.node, ev.device)
        self.last[key] = ev.ts
        gt = self.gap.setdefault(key, GapTracker(track_p99=False))
        gt.update(ev.ts)
        if gt.gaps.n == self.REF_SAMPLES:
            self.ref[key] = max(gt.gaps.mean, 1e-6)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or len(self.last) < 2:
            return []
        out = []
        by_node: dict[int, list[tuple[int, float]]] = {}
        for (node, dev), ts in self.last.items():
            by_node.setdefault(node, []).append((dev, ts))
        for node, devs in by_node.items():
            if len(devs) < 2:
                continue
            tss = [t for _, t in devs]
            newest = max(tss)
            for dev, ts in devs:
                gt = self.gap[(node, dev)]
                if gt.gaps.n < 16:
                    continue
                typical = self.ref.get((node, dev), max(gt.gaps.mean, 1e-6))
                silence = newest - ts
                # device went silent many decode-steps ago while peers
                # stream; the absolute floor rejects transient slot dips
                # that continuous batching refills within a poll or two
                if silence > max(self.cfg.starvation_factor * typical, 0.25):
                    out.append(self._mk(now, score=silence / typical,
                                        node=node, device=dev,
                                        silence=silence, step_gap=typical))
        return out


# ======================================================================
# Table 3(c) — East-West sensing runbook
# ======================================================================


class TPStraggler(Detector):
    """3c.1 — wide arrival spread of collective bursts (max-min gap up)."""

    name = "tp_straggler"
    table = "3c"
    stage = "compute (tensor-parallel collectives)"
    root_cause = "skewed device load / PCIe starvation / memory imbalance on one node"
    directive = "rebalance shards; check per-node PCIe feeds; adjust affinity"
    interested = frozenset({EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig, group_size: int = 0) -> None:
        super().__init__(cfg)
        self.spread: dict[int, SpreadTracker] = {}
        self.members: dict[int, set[int]] = {}
        self.group_size = group_size

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if _ext_group(ev.group):
            return
        members = self.members.setdefault(ev.group, set())
        members.add(ev.node)
        st = self.spread.get(ev.group)
        if st is None or st.expected != max(self.group_size, len(members)):
            st = SpreadTracker(expected=max(self.group_size, len(members)))
            self.spread[ev.group] = st
        st.update(ev.meta, ev.node, ev.ts)   # meta carries the round id

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for group, st in self.spread.items():
            counted = sum(st.late_counts.values())
            if st.rounds < 32 or counted < 16:
                continue
            worst = max(st.late_counts, key=st.late_counts.__getitem__)
            frac = st.late_counts[worst] / counted
            straggler = worst
            # one participant is consistently last AND the spread is a large
            # fraction of the inter-round period
            if frac > 0.6 and st.spread.mean > 0:
                z = st.spread.zscore(st.spread.mean + 2 * st.spread.std)
                out.append(self._mk(
                    now, score=frac * 10, node=straggler,
                    severity="critical" if frac > 0.85 else "warn",
                    group=group, straggler_frac=frac,
                    mean_spread=st.spread.mean))
        return out


class PPBubble(Detector):
    """3c.2 — large/growing gaps between stage-handoff bursts."""

    name = "pp_bubble_stage_stall"
    table = "3c"
    stage = "pipeline parallel"
    root_cause = "load imbalance across pipeline stages; early token-exit variance"
    directive = "adjust microbatch partitioning; reassign stages; speculative fill"
    interested = frozenset({EventKind.P2P_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.gap: dict[int, GapTracker] = {}     # stage-pair group -> gaps
        self.cusum: dict[int, CUSUM] = {}

    def update(self, ev: Event) -> None:
        if ev.meta != META_P2P_INTER:
            return
        self.events_seen += 1
        g = ev.group
        gap = self.gap.setdefault(g, GapTracker(track_p99=False)).gaps
        closed = self.gap[g].update(ev.ts)
        if closed > 0:
            self.cusum.setdefault(g, CUSUM(threshold=5.0)).update(closed)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for g, cs in self.cusum.items():
            if cs.stat > cs.threshold:
                gt = self.gap[g]
                out.append(self._mk(now, score=cs.stat, group=g,
                                    mean_gap=gt.gaps.mean,
                                    max_gap=gt.max_gap))
        return out


class CrossNodeLoadSkew(Detector):
    """3c.3 — uneven traffic volume per node for the same collective."""

    name = "cross_node_load_skew"
    table = "3c"
    stage = "TP/PP compute -> internode"
    root_cause = "shard imbalance; misaligned activation partitioning"
    directive = "validate shard sizes; rebalance across nodes"
    interested = frozenset({EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.bytes: dict[int, dict[int, float]] = {}   # group -> node -> bytes

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if _ext_group(ev.group):
            return
        nodes = self.bytes.setdefault(ev.group, {})
        nodes[ev.node] = nodes.get(ev.node, 0.0) + ev.size

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for group, nodes in self.bytes.items():
            if len(nodes) < 2:
                continue
            w = Welford()
            for v in nodes.values():
                w.update(v)
            cv = w.cv()
            if cv > self.cfg.skew_cv_warn:
                heavy = max(nodes, key=nodes.__getitem__)
                sev = "critical" if cv > self.cfg.skew_cv_crit else "warn"
                out.append(self._mk(now, score=cv * 10, node=heavy,
                                    severity=sev, group=group, cv=cv))
        return out


class NetworkCongestion(Detector):
    """3c.4 — periodic latency+jitter spikes across many links."""

    name = "network_congestion_oversubscription"
    table = "3c"
    stage = "internode transfers (collectives & stage handoff)"
    root_cause = "fat-tree oversubscription; ToR link hot spot"
    directive = "check fabric counters; adaptive routing; spread ranks"
    interested = frozenset({EventKind.COLLECTIVE_BURST, EventKind.P2P_BURST,
                            EventKind.QUEUE_SAMPLE})

    FABRIC_QUEUE = 2   # QUEUE_SAMPLE.meta for fabric queues

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.gap: dict[int, GapTracker] = {}       # per node
        self.fabric_depth = EWMA(0.05)
        self.last_depth = 0

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.QUEUE_SAMPLE:
            if ev.meta == self.FABRIC_QUEUE:
                self.fabric_depth.update(float(ev.depth))
                self.last_depth = ev.depth
            return
        if _ext_group(ev.group):
            return
        self.gap.setdefault(
            ev.node, GapTracker(track_p99=False)).update(ev.ts)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        jittery = 0
        measured = 0
        for gt in self.gap.values():
            if gt.gaps.n < 16:
                continue
            measured += 1
            if gt.jitter() > self.cfg.jitter_warn:
                jittery += 1
        qz = self.fabric_depth.zscore(float(self.last_depth))
        # cluster-wide: more than half the measured nodes turn jittery together
        if measured >= 2 and jittery >= max(2, measured // 2 + 1):
            score = jittery / measured * 10 + max(qz, 0.0)
            return [self._mk(now, score=score, jittery_nodes=jittery,
                             measured_nodes=measured,
                             fabric_queue_z=qz)]
        return []


class HeadOfLineBlocking(Detector):
    """3c.5 — some streams stall while others flow; out-of-order bursts."""

    name = "head_of_line_blocking"
    table = "3c"
    stage = "collective streams / P2P flows"
    root_cause = "shared queue-depth exhaustion; RoCE/NIC queue imbalance"
    directive = "increase NIC queue depth; QoS/ECN; verify fair sharing"
    interested = frozenset({EventKind.P2P_BURST, EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.flow_gap: dict[int, GapTracker] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        key = ev.flow if ev.flow >= 0 else ev.group
        self.flow_gap.setdefault(key, GapTracker()).update(ev.ts)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        stalled, flowing = [], 0
        for flow, gt in self.flow_gap.items():
            if gt.gaps.n < 8:
                continue
            base = max(gt.p99.value, 1e-6)
            if gt.current_gap(now) > self.cfg.starvation_factor * base:
                stalled.append(flow)
            else:
                flowing += 1
        # HoL signature: a strict subset stalls while the rest flows
        if stalled and flowing > 0:
            frac = len(stalled) / (len(stalled) + flowing)
            if 0.05 < frac < 0.9:
                return [self._mk(now, score=len(stalled),
                                 severity="warn" if frac < 0.5 else "critical",
                                 stalled_flows=len(stalled),
                                 flowing_flows=flowing)]
        return []


class EWRetransmitStorm(_RetransmitBase):
    """3c.6 — gaps + duplicate traffic or sudden retransmit storms."""

    name = "retransmissions_packet_loss"
    table = "3c"
    stage = "all distributed phases"
    root_cause = "fabric errors / congestion collapse / misconfigured PFC"
    directive = "verify lossless config; tune buffer thresholds; check optics"
    direction = META_DIR_EW
    traffic_kind = EventKind.COLLECTIVE_BURST


class CreditStarvation(Detector):
    """3c.7 — long silences until remote credit updates arrive."""

    name = "credit_starvation"
    table = "3c"
    stage = "internode (RDMA ops)"
    root_cause = "too-small RDMA window; NIC credit depletion"
    directive = "increase QP window; tune flow-control params"
    interested = frozenset({EventKind.CREDIT_UPDATE, EventKind.P2P_BURST,
                            EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.credit_gap: dict[int, GapTracker] = {}
        self.traffic: dict[int, RateMeter] = {}
        self.credits: dict[int, int] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.CREDIT_UPDATE:
            self.credit_gap.setdefault(
                ev.node, GapTracker(track_p99=False)).update(ev.ts)
            self.credits[ev.node] = ev.depth
        else:
            self.traffic.setdefault(ev.node, RateMeter(0.1)).update(
                ev.ts, ev.size)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        out = []
        for node, gt in self.credit_gap.items():
            if gt.gaps.n < 8:
                continue
            base = max(gt.gaps.mean, 1e-6)
            open_gap = gt.current_gap(now)
            low_credit = self.credits.get(node, 1 << 30) <= 1
            tr = self.traffic.get(node)
            link_quiet = tr is None or tr.byte_rate < 0.1 * self.cfg.ici_Bps
            if low_credit and link_quiet and open_gap > 4 * base:
                out.append(self._mk(now, score=open_gap / base, node=node,
                                    credit_gap=open_gap,
                                    credits=self.credits.get(node, 0)))
        return out


class KVCacheTransferBottleneck(Detector):
    """3c.8 — repeated large KV bursts for some tokens, others silent."""

    name = "kv_cache_transfer_bottleneck"
    table = "3c"
    stage = "decode phase (PP handoff)"
    root_cause = "sharded KV too large for link budget; non-uniform lengths"
    directive = "compress KV; shard differently; apply caching policies"
    interested = frozenset({EventKind.P2P_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.flow_bytes: dict[int, float] = {}
        self.burst_size = EWMA(0.05)
        self.rate = RateMeter(0.1)

    def update(self, ev: Event) -> None:
        if ev.meta != META_P2P_KV:
            return
        self.events_seen += 1
        self.flow_bytes[ev.flow] = self.flow_bytes.get(ev.flow, 0.0) + ev.size
        self.burst_size.update(float(ev.size))
        self.rate.update(ev.ts, ev.size)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or len(self.flow_bytes) < 4:
            return []
        w = Welford()
        for v in self.flow_bytes.values():
            w.update(v)
        cv = w.cv()
        link_frac = self.rate.byte_rate / self.cfg.ici_Bps
        if cv > self.cfg.skew_cv_crit and link_frac > 0.3:
            return [self._mk(now, score=cv * 10, cv=cv,
                             link_utilization=link_frac,
                             mean_burst=self.burst_size.mean)]
        return []


class EarlyStopSkewAcrossNodes(Detector):
    """3c.9 — some nodes stop sending mid-iteration while others continue."""

    name = "early_stop_skew_across_nodes"
    table = "3c"
    stage = "decode (multi-node)"
    root_cause = "sequence-length divergence; scheduler not masking early exits"
    directive = "enable dynamic remapping; mask early-stop ranks"
    # collective participation is the signal; a stopped rank may still move
    # unrelated P2P traffic, so only COLLECTIVE_BURST counts as "sending"
    interested = frozenset({EventKind.COLLECTIVE_BURST})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.last: dict[int, float] = {}
        self.gap: dict[int, GapTracker] = {}

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        self.last[ev.node] = ev.ts
        self.gap.setdefault(
            ev.node, GapTracker(track_p99=False)).update(ev.ts)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or len(self.last) < 2:
            return []
        newest = max(self.last.values())
        out = []
        silent, active = [], 0
        for node, ts in self.last.items():
            gt = self.gap[node]
            if gt.gaps.n < 8:
                continue
            typical = max(gt.gaps.mean, 1e-6)
            if newest - ts > self.cfg.starvation_factor * typical:
                silent.append((node, (newest - ts) / typical))
            else:
                active += 1
        if silent and active > 0:
            worst = max(s for _, s in silent)
            node = max(silent, key=lambda x: x[1])[0]
            out.append(self._mk(now, score=worst, node=node,
                                silent_nodes=[n for n, _ in silent],
                                active_nodes=active))
        return out


# ======================================================================
# Table 3(d) — Data-parallel replica runbook (cross-replica router view)
# ======================================================================


class CrossReplicaSkew(Detector):
    """3d.1 — per-replica EGRESS-rate divergence + queue-depth imbalance.

    The DP-layer pathology: a router policy (or the affinity/staleness
    defeating it) concentrates load on a subset of replicas.  From the DPU
    vantage this is per-replica egress token rates drifting apart while the
    hot replica's ingress queue grows and its peers' queues drain — both
    signals the NIC-side observer already exports.  Node-level detectors
    cannot see it: each node looks locally healthy, just unevenly busy.
    """

    name = "cross_replica_skew"
    table = "3d"
    stage = "ingress routing -> decode (data-parallel replicas)"
    root_cause = "router policy imbalance / stale router view / degraded replica"
    directive = "rebalance replicas; refresh router view; drain hot replica"
    interested = frozenset({EventKind.EGRESS_PKT, EventKind.QUEUE_SAMPLE})

    PERSIST = 2          # consecutive skewed polls before firing
    MIN_QUEUE_GAP = 8    # absolute hot-vs-mean queue depth floor
    MIN_CONC_TOTAL = 32  # backlog floor for the concentration signal
    CONC_FRAC = 0.6      # one replica holds this share of the total backlog

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.egress: dict[int, RateMeter] = {}       # replica -> token rate
        self.depth: dict[int, dict[int, int]] = {}   # replica -> node -> depth
        self.streak = 0

    def update(self, ev: Event) -> None:
        if ev.replica < 0:
            return
        self.events_seen += 1
        if ev.kind == EventKind.EGRESS_PKT:
            self.egress.setdefault(
                ev.replica, RateMeter(halflife=0.15)).update(ev.ts, ev.size)
        elif ev.meta == META_DIR_INGRESS:
            self.depth.setdefault(ev.replica, {})[ev.node] = ev.depth

    def update_batch(self, batch: EventBatch) -> None:
        reps = batch.replica
        valid = reps >= 0
        n = int(valid.sum())
        if n == 0:
            return
        self.events_seen += n
        is_egress = batch.kind == EventKind.EGRESS_PKT
        eg = valid & is_egress
        if eg.any():
            buckets: dict[int, tuple[list, list]] = {}
            for r, ts, sz in zip(reps[eg].tolist(), batch.ts[eg].tolist(),
                                 batch.size[eg].tolist()):
                b = buckets.get(r)
                if b is None:
                    buckets[r] = ([ts], [sz])
                else:
                    b[0].append(ts)
                    b[1].append(sz)
            egress = self.egress
            for r, (tss, sizes) in buckets.items():
                m = egress.get(r)
                if m is None:
                    m = egress[r] = RateMeter(halflife=0.15)
                m.update_many(tss, sizes)
        qs = valid & ~is_egress & (batch.meta == META_DIR_INGRESS)
        if qs.any():
            depth = self.depth
            for r, node, dep in zip(reps[qs].tolist(),
                                    batch.node[qs].tolist(),
                                    batch.depth[qs].tolist()):
                d = depth.get(r)
                if d is None:
                    d = depth[r] = {}
                d[node] = dep

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or len(self.egress) < 2:
            return []
        rates = {r: m.rate_at(now) for r, m in self.egress.items()}
        w = Welford()
        for v in rates.values():
            w.update(v)
        rate_cv = w.cv()
        depths = {r: sum(nodes.values())
                  for r, nodes in self.depth.items()} or {r: 0 for r in rates}
        for r in rates:
            depths.setdefault(r, 0)
        d_total = sum(depths.values())
        d_mean = d_total / len(depths)
        d_max = max(depths.values())
        queue_gap = d_max - d_mean
        # concentration: one replica holds most of the cluster backlog.
        # Catches the rotating hot spot a stale router view produces, where
        # the victim identity changes faster than rate divergence builds.
        concentrated = (d_total >= self.MIN_CONC_TOTAL
                        and d_max / d_total > self.CONC_FRAC)
        skewed = (rate_cv > self.cfg.skew_cv_warn
                  and queue_gap >= self.MIN_QUEUE_GAP) \
            or concentrated or rate_cv > 1.5 * self.cfg.skew_cv_crit
        self.streak = self.streak + 1 if skewed else 0
        if self.streak < self.PERSIST:
            return []
        # the pathological replica: deepest backlog, ties to slowest egress
        hot = max(depths, key=lambda r: (depths[r], -rates.get(r, 0.0)))
        sev = ("critical"
               if rate_cv > self.cfg.skew_cv_crit or concentrated
               or queue_gap > 3 * self.MIN_QUEUE_GAP else "warn")
        return [self._mk(
            now, score=rate_cv * 10 + queue_gap / self.MIN_QUEUE_GAP,
            node=hot, severity=sev, replica=hot, rate_cv=rate_cv,
            queue_gap=queue_gap, concentrated=concentrated,
            egress_rates={r: round(v, 1) for r, v in rates.items()},
            queue_depths=depths)]


class HierarchicalRoutingSkew(Detector):
    """3d.2 — intra-replica node skew the replica tier cannot see.

    The hierarchical routing pathology: request *placement* concentrates on
    one node inside a replica (replica-local scheduler affinity, a broken
    TP-group spread) while the replica totals stay balanced — so the
    replica-tier detector (3d.1) is blind to it and the flat router never
    compensates.  From the DPU vantage this is per-node ingress-rate
    concentration within a replica (one node receives most of the
    replica's request bytes) corroborated by that same node's ingress
    queue outgrowing its siblings.  Keying on ingress *placement* rather
    than queue depth alone is what separates this row from a slow node
    (3b): a starved/slow node drains slowly under an even feed; here the
    feed itself is skewed.

    Node -> replica membership is learned from the ingress QUEUE_SAMPLEs
    (which carry both coordinates), so the detector needs no topology
    configuration.
    """

    name = "hierarchical_routing_skew"
    table = "3d"
    stage = "ingress routing -> intra-replica node placement"
    root_cause = ("replica-local placement affinity / broken TP-group "
                  "spread concentrating requests on one node")
    directive = ("rebalance queued requests across the replica's nodes; "
                 "fix the intra-replica spread policy")
    interested = frozenset({EventKind.INGRESS_PKT, EventKind.QUEUE_SAMPLE})

    PERSIST = 2          # consecutive skewed polls before firing
    MIN_SHARE = 0.65     # one node's share of its replica's ingress packets
    CRIT_SHARE = 0.80
    MIN_QUEUE_GAP = 8    # hot-node vs replica-mean queue depth floor
    MIN_RATE = 40.0      # ingress packets/s floor (quiet != skewed)

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.rate: dict[int, RateMeter] = {}      # node -> ingress rate
        self.node_replica: dict[int, int] = {}    # learned membership
        self.depth: dict[int, int] = {}           # node -> ingress depth
        self.streak = 0

    def update(self, ev: Event) -> None:
        if ev.kind == EventKind.INGRESS_PKT:
            # flow < 0 is background/bulk traffic, not request placement
            if ev.node < 0 or ev.flow < 0:
                return
            self.events_seen += 1
            m = self.rate.get(ev.node)
            if m is None:
                m = self.rate[ev.node] = RateMeter(halflife=0.15)
            m.update(ev.ts, ev.size)
        elif (ev.kind == EventKind.QUEUE_SAMPLE
              and ev.meta == META_DIR_INGRESS
              and ev.replica >= 0 and ev.node >= 0):
            self.events_seen += 1
            self.node_replica[ev.node] = ev.replica
            self.depth[ev.node] = ev.depth

    def update_batch(self, batch: EventBatch) -> None:
        is_ing = batch.kind == EventKind.INGRESS_PKT
        ing = is_ing & (batch.node >= 0) & (batch.flow >= 0)
        if ing.any():
            self.events_seen += int(ing.sum())
            buckets: dict[int, tuple[list, list]] = {}
            for n, ts, sz in zip(batch.node[ing].tolist(),
                                 batch.ts[ing].tolist(),
                                 batch.size[ing].tolist()):
                b = buckets.get(n)
                if b is None:
                    buckets[n] = ([ts], [sz])
                else:
                    b[0].append(ts)
                    b[1].append(sz)
            rate = self.rate
            for n, (tss, sizes) in buckets.items():
                m = rate.get(n)
                if m is None:
                    m = rate[n] = RateMeter(halflife=0.15)
                m.update_many(tss, sizes)
        qs = (~is_ing & (batch.meta == META_DIR_INGRESS)
              & (batch.replica >= 0) & (batch.node >= 0))
        if qs.any():
            self.events_seen += int(qs.sum())
            nr, dep = self.node_replica, self.depth
            for n, r, d in zip(batch.node[qs].tolist(),
                               batch.replica[qs].tolist(),
                               batch.depth[qs].tolist()):
                nr[n] = r
                dep[n] = d

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        groups: dict[int, list[int]] = {}
        for n, r in self.node_replica.items():
            groups.setdefault(r, []).append(n)
        # the row is *hierarchical* by definition: it needs >= 2 multi-node
        # replicas so "replica tier balanced, node tier skewed" is even
        # expressible — a lone replica's node skew belongs to the 3b rows
        multi = {r: nodes for r, nodes in groups.items() if len(nodes) >= 2}
        if len(multi) < 2:
            self.streak = 0
            return []
        rates = {r: {n: (self.rate[n].rate_at(now) if n in self.rate
                         else 0.0) for n in nodes}
                 for r, nodes in multi.items()}
        totals = {r: sum(v.values()) for r, v in rates.items()}
        grand = sum(totals.values())
        if grand < self.MIN_RATE:
            self.streak = 0
            return []
        # replica tier must look *balanced* — a concentrated replica tier
        # is 3d.1's territory, not this row's
        if max(totals.values()) / grand >= self.MIN_SHARE:
            self.streak = 0
            return []
        worst = None
        for r, nodes in multi.items():
            total = totals[r]
            if total < self.MIN_RATE / len(multi):
                continue
            hot = max(nodes, key=lambda n: (rates[r][n],
                                            self.depth.get(n, 0)))
            share = rates[r][hot] / total
            depths = [self.depth.get(n, 0) for n in nodes]
            gap = self.depth.get(hot, 0) - sum(depths) / len(depths)
            if share >= self.MIN_SHARE and gap >= self.MIN_QUEUE_GAP:
                cand = (share, gap, r, hot,
                        {n: round(v, 1) for n, v in rates[r].items()},
                        {n: self.depth.get(n, 0) for n in nodes})
                if worst is None or cand[:2] > worst[:2]:
                    worst = cand
        self.streak = self.streak + 1 if worst is not None else 0
        if self.streak < self.PERSIST:
            return []
        share, gap, replica, hot, hot_rates, depths = worst
        sev = ("critical" if share >= self.CRIT_SHARE
               or gap > 3 * self.MIN_QUEUE_GAP else "warn")
        return [self._mk(
            now, score=share * 10 + gap / self.MIN_QUEUE_GAP,
            node=hot, severity=sev, replica=replica,
            ingress_share=round(share, 3), queue_gap=gap,
            node_rates=hot_rates, node_depths=depths)]


# ======================================================================
# Table 3(e) — per-collective / topology-tier runbook
# ======================================================================


class CollectiveStragglerLag(Detector):
    """3e.1 — one node's per-op finish edge lags the group median.

    Consumes only the per-collective finish rows (all-gather /
    reduce-scatter tier, ``COLL_EDGE_FINISH``): each op round is buffered
    until its round id rolls over, then the straggler lag is the worst
    node's finish timestamp against the round median.  The aggregate
    tp_straggler row (3c.1) sees one merged burst per round and is blind
    to which *op* a rank is late into; this row is the per-op refinement.
    """

    name = "collective_straggler"
    table = "3e"
    stage = "compute (per-collective ops: all-gather / reduce-scatter)"
    root_cause = ("one rank consistently late into its collectives "
                  "(device slowdown, local contention)")
    directive = "rebalance shards toward the lagging rank; check its feeds"
    interested = frozenset({EventKind.COLLECTIVE_BURST})

    PERSIST = 2          # consecutive qualifying polls before firing
    MIN_LAG = 1e-4       # healthy finish jitter is ~2e-5; fault lag ~1.5e-3
    MIN_ROUNDS = 24      # finalized op rounds before the row may fire
    MIN_COUNTED = 12     # rounds with a measurable laggard
    LATE_FRAC = 0.6      # one node must own this share of late rounds
    CRIT_FRAC = 0.85

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        # per op-group open round: group -> (round id, node -> finish ts)
        self.open: dict[int, tuple[int, dict[int, float]]] = {}
        self.rounds = 0
        self.late: dict[int, int] = {}
        self.counted = 0
        self.lag = EWMA(0.1)
        self.streak = 0

    def _finalize(self, fins: dict[int, float]) -> None:
        self.rounds += 1
        if len(fins) < 2:
            return
        ts = sorted(fins.values())
        median = ts[len(ts) // 2]
        worst = max(fins, key=fins.__getitem__)
        lag = fins[worst] - median
        self.lag.update(lag)
        if lag > self.MIN_LAG:
            self.late[worst] = self.late.get(worst, 0) + 1
            self.counted += 1

    def _ingest(self, group: int, rid: int, node: int, ts: float) -> None:
        cur = self.open.get(group)
        if cur is None or cur[0] != rid:
            if cur is not None:
                self._finalize(cur[1])
            self.open[group] = (rid, {node: ts})
        else:
            cur[1][node] = ts

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        g = ev.group
        if (g != COLL_GROUP_ALL_GATHER and g != COLL_GROUP_REDUCE_SCATTER) \
                or ev.depth != COLL_EDGE_FINISH:
            return
        self._ingest(g, ev.meta, ev.node, ev.ts)   # meta carries the round

    def update_batch(self, batch: EventBatch) -> None:
        # single-kind safe: only COLLECTIVE_BURST arrives; rows keep wire
        # order within the kind, so round rollovers finalize exactly like
        # the scalar path
        self.events_seen += len(batch)
        m = (((batch.group == COLL_GROUP_ALL_GATHER)
              | (batch.group == COLL_GROUP_REDUCE_SCATTER))
             & (batch.depth == COLL_EDGE_FINISH))
        if not m.any():
            return
        for g, rid, node, ts in zip(batch.group[m].tolist(),
                                    batch.meta[m].tolist(),
                                    batch.node[m].tolist(),
                                    batch.ts[m].tolist()):
            self._ingest(g, rid, node, ts)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        worst, frac = -1, 0.0
        if self.rounds >= self.MIN_ROUNDS and self.counted \
                >= self.MIN_COUNTED:
            worst = max(self.late, key=self.late.__getitem__)
            frac = self.late[worst] / self.counted
        qualifies = (worst >= 0 and frac > self.LATE_FRAC
                     and self.lag.mean > self.MIN_LAG)
        self.streak = self.streak + 1 if qualifies else 0
        if self.streak < self.PERSIST:
            return []
        return [self._mk(
            now, score=frac * 10, node=worst,
            severity="critical" if frac > self.CRIT_FRAC else "warn",
            late_frac=round(frac, 3), mean_finish_lag=self.lag.mean,
            op_rounds=self.rounds)]


class RailCongestion(Detector):
    """3e.2 — cross-domain op slowdown concentrated on one shared rail.

    Cross-domain collective legs ride per-rail groups
    (``RAIL_GROUP_BASE + r``).  Per round, the mean finish time of each
    rail's legs is compared against the fastest rail; a congested rail is
    consistently the slow one by more than the healthy jitter floor.  One
    slow *node* shifts only its own legs; a slow *rail* shifts every leg
    that shares it — which is what separates this row from 3e.1/3c.1.
    """

    name = "rail_congestion"
    table = "3e"
    stage = "internode transfers (cross-domain rail tier)"
    root_cause = ("oversubscribed / degraded rail shared by cross-domain "
                  "collective legs")
    directive = "reroute cross-domain legs off the hot rail; respread ranks"
    interested = frozenset({EventKind.COLLECTIVE_BURST})

    PERSIST = 2
    MIN_LAG = 5e-5       # healthy inter-rail mean spread is ~1e-5
    MIN_ROUNDS = 24
    MIN_COUNTED = 12
    DOM_FRAC = 0.65      # one rail must own this share of slow rounds

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.open_rid: int | None = None
        self.acc: dict[int, tuple[float, int]] = {}   # rail -> (sum_ts, n)
        self.rails: set[int] = set()
        self.rounds = 0
        self.late: dict[int, int] = {}
        self.counted = 0
        self.lag = EWMA(0.1)
        self.streak = 0

    def _finalize(self) -> None:
        self.rounds += 1
        if len(self.acc) >= 2:
            means = {r: s / n for r, (s, n) in self.acc.items()}
            fast = min(means.values())
            slow = max(means, key=means.__getitem__)
            lag = means[slow] - fast
            self.lag.update(lag)
            if lag > self.MIN_LAG:
                self.late[slow] = self.late.get(slow, 0) + 1
                self.counted += 1
        self.acc = {}

    def _ingest(self, rail: int, rid: int, ts: float) -> None:
        if self.open_rid != rid:
            if self.open_rid is not None:
                self._finalize()
            self.open_rid = rid
        self.rails.add(rail)
        cur = self.acc.get(rail)
        self.acc[rail] = (ts, 1) if cur is None else (cur[0] + ts,
                                                      cur[1] + 1)

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        g = ev.group
        if g < RAIL_GROUP_BASE or g >= DOMAIN_GROUP_BASE:
            return
        self._ingest(g - RAIL_GROUP_BASE, ev.meta, ev.ts)

    def update_batch(self, batch: EventBatch) -> None:
        # single-kind safe (COLLECTIVE_BURST only); wire order preserved
        self.events_seen += len(batch)
        m = (batch.group >= RAIL_GROUP_BASE) & (batch.group
                                                < DOMAIN_GROUP_BASE)
        if not m.any():
            return
        for g, rid, ts in zip(batch.group[m].tolist(),
                              batch.meta[m].tolist(),
                              batch.ts[m].tolist()):
            self._ingest(g - RAIL_GROUP_BASE, rid, ts)

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events:
            return []
        hot, frac = -1, 0.0
        if (len(self.rails) >= 2 and self.rounds >= self.MIN_ROUNDS
                and self.counted >= self.MIN_COUNTED):
            hot = max(self.late, key=self.late.__getitem__)
            frac = self.late[hot] / self.counted
        qualifies = (hot >= 0 and frac > self.DOM_FRAC
                     and self.lag.mean > self.MIN_LAG)
        self.streak = self.streak + 1 if qualifies else 0
        if self.streak < self.PERSIST:
            return []
        return [self._mk(
            now, score=frac * 10, node=-1,
            severity="critical" if frac > 0.85 else "warn",
            rail=hot, slow_frac=round(frac, 3),
            mean_rail_lag=self.lag.mean, rail_rounds=self.rounds)]


class HbmBandwidthCliff(Detector):
    """3e.3 — decode token-rate sag with flat queues at peak batch size.

    The memory-bandwidth cliff: past a batch-size knee the decode phase
    turns bandwidth-bound and per-node egress token rate sags, while the
    NIC-side ingress queues stay shallow — so every queue-keyed row stays
    silent.  The DPU-visible signature is the *conjunction*: egress rate
    well below its own learned peak, AND a flat ingress queue, AND the
    scheduler's exported batch occupancy at its observed maximum.  Batch
    occupancy at max is what attributes the sag to batch size rather than
    to upstream starvation (starved nodes run *small* batches).
    """

    name = "hbm_bandwidth_cliff"
    table = "3e"
    stage = "decode (device memory bandwidth)"
    root_cause = ("decode batch past the memory-bandwidth knee; token rate "
                  "saturates while queues stay flat")
    directive = "shrink the decode batch below the knee; re-spread slots"
    interested = frozenset({EventKind.QUEUE_SAMPLE, EventKind.EGRESS_PKT})

    PERSIST = 2
    SAG = 0.7            # rate below this fraction of the learned peak
    CRIT_SAG = 0.5
    MIN_PEAK = 500.0     # egress events/s floor (quiet nodes never "sag")
    FLAT_DEPTH = 10      # "flat queue" = ingress depth at/below this

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.rate: dict[int, RateMeter] = {}     # node -> egress event rate
        self.peak: dict[int, float] = {}         # node -> peak rate seen
        self.qdepth: dict[int, int] = {}         # node -> ingress depth
        self.batch: dict[int, int] = {}          # node -> active batch size
        self.bmax: dict[int, int] = {}           # node -> max batch seen
        self.streak = 0

    def update(self, ev: Event) -> None:
        self.events_seen += 1
        if ev.kind == EventKind.EGRESS_PKT:
            m = self.rate.get(ev.node)
            if m is None:
                m = self.rate[ev.node] = RateMeter(halflife=0.1)
            m.update(ev.ts, ev.size)
        elif ev.meta == META_BATCH_OCC:
            self.batch[ev.node] = ev.depth
            if ev.depth > self.bmax.get(ev.node, 0):
                self.bmax[ev.node] = ev.depth
        elif ev.meta == META_DIR_INGRESS:
            self.qdepth[ev.node] = ev.depth

    def update_batch(self, batch: EventBatch) -> None:
        # per-kind sub-batches: EGRESS_PKT and QUEUE_SAMPLE state are
        # disjoint, and decisions only happen at poll(), so kind-partition
        # delivery is order-safe
        self.events_seen += len(batch)
        kinds = batch.kind
        eg = kinds == EventKind.EGRESS_PKT
        if eg.any():
            buckets: dict[int, tuple[list, list]] = {}
            for n, ts, sz in zip(batch.node[eg].tolist(),
                                 batch.ts[eg].tolist(),
                                 batch.size[eg].tolist()):
                b = buckets.get(n)
                if b is None:
                    buckets[n] = ([ts], [sz])
                else:
                    b[0].append(ts)
                    b[1].append(sz)
            rate = self.rate
            for n, (tss, sizes) in buckets.items():
                m = rate.get(n)
                if m is None:
                    m = rate[n] = RateMeter(halflife=0.1)
                m.update_many(tss, sizes)
        occ = ~eg & (batch.meta == META_BATCH_OCC)
        if occ.any():
            bat, bmax = self.batch, self.bmax
            for n, d in zip(batch.node[occ].tolist(),
                            batch.depth[occ].tolist()):
                bat[n] = d
                if d > bmax.get(n, 0):
                    bmax[n] = d
        ing = ~eg & (batch.meta == META_DIR_INGRESS)
        if ing.any():
            qd = self.qdepth
            for n, d in zip(batch.node[ing].tolist(),
                            batch.depth[ing].tolist()):
                qd[n] = d

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.cfg.min_events or not self.batch:
            # structural gate: no scheduler batch-occupancy tap exported
            # means the attribution to batch size is inexpressible
            return []
        worst = None
        for node, meter in self.rate.items():
            r = meter.rate_at(now)
            peak = self.peak.get(node, 0.0)
            if r > peak:
                self.peak[node] = peak = r
            b = self.batch.get(node)
            if b is None or peak < self.MIN_PEAK:
                continue
            sag = r / peak
            depth = self.qdepth.get(node, 0)
            # the cliff conjunction: sagging rate + flat queue + batch
            # pinned at its observed max (a drained node fails the batch
            # gate, a backlogged node fails the flat-queue gate)
            if (sag < self.SAG and depth <= self.FLAT_DEPTH
                    and b >= self.bmax.get(node, b) - 1):
                if worst is None or sag < worst[0]:
                    worst = (sag, node, b, depth)
        self.streak = self.streak + 1 if worst is not None else 0
        if self.streak < self.PERSIST:
            return []
        sag, node, b, depth = worst
        return [self._mk(
            now, score=(1.0 - sag) * 10, node=node,
            severity="critical" if sag < self.CRIT_SAG else "warn",
            rate_vs_peak=round(sag, 3), batch_size=b,
            ingress_depth=depth)]


# ======================================================================
# DPU self-diagnosis — the telemetry plane watching itself
# ======================================================================


class DPUSaturation(Detector):
    """dpu.1 — the DPU's own ingest budget saturates and sheds load.

    Signal source is the sidecar's self-telemetry (``META_DPU_RING``
    QUEUE_SAMPLEs: ring occupancy percent in ``depth``, rows shed since the
    previous sample in ``size``).  Any shed is critical — findings are now
    provably incomplete; sustained high occupancy without shed is the
    warning precursor.  This row exists because a control plane that cannot
    notice its *own* overload silently degrades every other row.
    """

    name = "dpu_saturation"
    table = "dpu"
    stage = "telemetry plane (all vantages degraded)"
    root_cause = "event volume exceeds DPU ingest/compute budget " \
                 "(debug-tap storm, line-rate burst, undersized budget)"
    directive = "raise tap sampling stride; shed low-priority event " \
                "classes; bound per-class event rates"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    WARN_OCCUPANCY = 80      # ring percent considered "about to shed"
    MIN_SAMPLES = 4          # self-samples before the row may fire

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self.occ = 0             # latest ring occupancy percent
        self.occ_peak = 0        # peak since the last poll
        self.shed = 0            # rows shed since the last poll

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_DPU_RING:
            return
        self.events_seen += 1
        self.occ = int(ev.depth)
        if self.occ > self.occ_peak:
            self.occ_peak = self.occ
        self.shed += int(ev.size)

    def update_batch(self, batch: EventBatch) -> None:
        # single-kind safe: only QUEUE_SAMPLE rows arrive; order within the
        # kind is wire order, so "latest occupancy" matches the scalar path
        m = batch.meta == META_DPU_RING
        if not m.any():
            return
        self.events_seen += int(m.sum())
        depths = batch.depth[m]
        self.occ = int(depths[-1])
        peak = int(depths.max())
        if peak > self.occ_peak:
            self.occ_peak = peak
        self.shed += int(batch.size[m].sum())

    def poll(self, now: float) -> list[Finding]:
        if self.events_seen < self.MIN_SAMPLES:
            # keep accumulating: sheds during warmup must surface in the
            # first eligible poll, not vanish
            return []
        shed, self.shed = self.shed, 0
        peak, self.occ_peak = self.occ_peak, self.occ
        if shed > 0:
            return [self._mk(now, score=10.0 + shed / 100.0,
                             severity="critical", shed_rows=shed,
                             ring_occupancy_pct=peak)]
        if peak >= self.WARN_OCCUPANCY:
            return [self._mk(now, score=peak / 10.0, severity="warn",
                             shed_rows=0, ring_occupancy_pct=peak)]
        return []


# ======================================================================
# Monitoring-plane robustness ("mon" table) — watching the watcher.
# Signal sources are self-telemetry rows (sidecar ingest guard, command
# bus) and the host watchdog's heartbeat probes; none of these rows exist
# on a healthy monitoring plane, so the detectors are structurally silent
# on every data-path scenario.
# ======================================================================


class DPUOutage(Detector):
    """mon.1 — the DPU itself went dark.

    Signal source is the host-side watchdog's heartbeat probe stream
    (``META_MON_HEARTBEAT``), emitted into the *standby* plane over the
    BlueField's out-of-band management port: ``size`` is 1 while the DPU
    has been silent past the watchdog timeout, ``depth`` carries the
    silence in milliseconds.  Two consecutive silent probes make the
    outage critical — one probe can race a slow scheduling round.
    """

    name = "dpu_outage"
    table = "mon"
    stage = "monitoring plane (all detection + actuation dark)"
    root_cause = "DPU crash/hang/power-cycle, or management-path loss " \
                 "of the telemetry sidecar"
    directive = "fail over to the degraded host-side controller; " \
                "fail back with hysteresis when heartbeats resume"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    MIN_SILENT = 2           # consecutive silent probes before firing

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self._silent_run = 0     # consecutive silent probes
        self._silence_ms = 0

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_MON_HEARTBEAT:
            return
        self.events_seen += 1
        if int(ev.size) > 0:
            self._silent_run += 1
            self._silence_ms = int(ev.depth)
        else:
            self._silent_run = 0
            self._silence_ms = 0

    def poll(self, now: float) -> list[Finding]:
        if self._silent_run < self.MIN_SILENT:
            return []
        return [self._mk(now, score=10.0 + self._silence_ms / 100.0,
                         severity="critical",
                         silent_probes=self._silent_run,
                         silence_ms=self._silence_ms)]


class TelemetryBlackout(Detector):
    """mon.2 — the telemetry stream to the DPU tore.

    Signal source is the sidecar ingest guard's latched dirty rows
    (``META_MON_INGEST``): ``size`` counts sequence numbers missing plus
    batches dropped for checksum corruption since the last resync,
    ``depth`` counts replayed duplicates dropped.  The latch means the
    row keeps firing until a host-side ``resync_telemetry`` actuation
    lands — detection survives its own actuation quarantine.
    """

    name = "telemetry_blackout"
    table = "mon"
    stage = "telemetry ingest (detection blind for the gap window)"
    root_cause = "uplink partition/blackout, tap corruption, or replayed " \
                 "frames on the telemetry path"
    directive = "re-register the telemetry tap and resync the sequence " \
                "stream; quarantine actuation until detectors re-warm"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self._lost = 0           # latest latched missing+corrupt count
        self._replays = 0
        self._seen_this_poll = 0

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_MON_INGEST:
            return
        self.events_seen += 1
        self._seen_this_poll += 1
        self._lost = int(ev.size)
        self._replays = int(ev.depth)

    def poll(self, now: float) -> list[Finding]:
        seen, self._seen_this_poll = self._seen_this_poll, 0
        if seen == 0 or self._lost <= 0:
            return []
        return [self._mk(now, score=8.0 + self._lost / 1000.0,
                         severity="critical", lost_batches=self._lost,
                         replays_dropped=self._replays)]


class CommandPartition(Detector):
    """mon.3 — the command/actuation channel is partitioned.

    Signal source is the bus-health self-telemetry (``META_MON_BUS``):
    ``size`` is the cumulative count of commands (including liveness
    pings) that burned every retry unacked.  A merely lossy channel lands
    most retries; repeated *exhaustion* with no intervening ack means
    nothing is getting through, which is a different failure class than
    ``lossy_command_channel`` and needs failover, not patience.
    """

    name = "command_partition"
    table = "mon"
    stage = "actuation path (detection intact, mitigation dark)"
    root_cause = "downlink/ack-channel partition between DPU and host " \
                 "actuator"
    directive = "fail actuation over to the host-side controller until " \
                "the command channel round-trips again"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    MIN_EXHAUSTED = 3        # a lossy-but-alive channel stays below this

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self._exhausted = 0
        self._retries = 0
        self._seen_this_poll = 0

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_MON_BUS:
            return
        self.events_seen += 1
        self._seen_this_poll += 1
        self._exhausted = int(ev.size)
        self._retries = int(ev.depth)

    def poll(self, now: float) -> list[Finding]:
        seen, self._seen_this_poll = self._seen_this_poll, 0
        if seen == 0 or self._exhausted < self.MIN_EXHAUSTED:
            return []
        return [self._mk(now, score=9.0 + self._exhausted / 10.0,
                         severity="critical",
                         exhausted_commands=self._exhausted,
                         retries=self._retries)]


class StandbyLag(Detector):
    """mon.4 — the hot standby's detector state fell measurably behind.

    Signal source is the watchdog's standby-shadow probe
    (``META_MON_STANDBY``): ``size`` carries how far the standby
    sidecar's tap clock lags the primary's, in milliseconds.  A healthy
    mirrored tap keeps the two within one link delay of each other; a
    sustained lag means the standby leg of the fan-out is dropping or
    partitioned, and a failover right now would promote a sidecar whose
    detectors are warm on *stale* state.  Critical because the lag
    silently voids the hot-failover guarantee — the deployment is one
    primary fault away from a cold promotion.
    """

    name = "standby_lag"
    table = "mon"
    stage = "monitoring plane (redundancy silently degraded)"
    root_cause = "standby tap leg dropping/partitioned, or standby " \
                 "sidecar wedged while the primary stays healthy"
    directive = "re-mirror the standby from the watchdog's retained tap " \
                "history and resync its sequence stream"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    LAG_MS = 250             # one detector poll interval, with margin

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self._lag_ms = 0
        self._standby_up = 1
        self._seen_this_poll = 0

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_MON_STANDBY:
            return
        self.events_seen += 1
        self._seen_this_poll += 1
        self._lag_ms = int(ev.size)
        self._standby_up = int(ev.depth)

    def poll(self, now: float) -> list[Finding]:
        seen, self._seen_this_poll = self._seen_this_poll, 0
        if seen == 0 or self._lag_ms < self.LAG_MS:
            return []
        return [self._mk(now, score=8.5 + self._lag_ms / 1000.0,
                         severity="critical", lag_ms=self._lag_ms,
                         standby_up=self._standby_up)]


class SplitBrainFenced(Detector):
    """mon.5 — a stale-term command reached the host actuator.

    Signal source is the watchdog's fencing probe (``META_MON_FENCE``):
    ``size`` counts commands the actuator rejected since the last probe
    because they carried a term older than the granted lease, ``depth``
    is the term currently in force.  One fenced command is already an
    incident: a deposed sidecar is alive, partitioned from the lease
    arbiter, and still trying to drive mitigation — only the fence stood
    between the cluster and double actuation.  Critical and immediate.
    """

    name = "split_brain_fenced"
    table = "mon"
    stage = "actuation path (double-actuation attempt blocked)"
    root_cause = "deposed sidecar still actuating: OOB partition hid its " \
                 "demotion while its command path stayed alive"
    directive = "deliver the current term to the stale sidecar " \
                "(quiesce it) and purge its outstanding commands"
    interested = frozenset({EventKind.QUEUE_SAMPLE})

    def __init__(self, cfg: DetectorConfig) -> None:
        super().__init__(cfg)
        self._fenced = 0
        self._term = 0
        self._seen_this_poll = 0

    def update(self, ev: Event) -> None:
        if ev.kind != EventKind.QUEUE_SAMPLE or ev.meta != META_MON_FENCE:
            return
        self.events_seen += 1
        self._seen_this_poll += 1
        self._fenced += int(ev.size)
        self._term = int(ev.depth)

    def poll(self, now: float) -> list[Finding]:
        seen, self._seen_this_poll = self._seen_this_poll, 0
        fenced, self._fenced = self._fenced, 0
        if seen == 0 or fenced <= 0:
            return []
        return [self._mk(now, score=9.5 + fenced / 10.0,
                         severity="critical", fenced_commands=fenced,
                         granted_term=self._term)]


ALL_DETECTORS: tuple[type[Detector], ...] = (
    # 3(a)
    BurstAdmissionBacklog, IngressStarvation, FlowSkewAcrossSessions,
    IngressDropRetransmit, EgressBacklogQueueing, EgressJitter,
    EgressDropRetransmit, EarlyCompletionSkew, BandwidthSaturation,
    # 3(b)
    H2DDataStarvation, D2HReturnBottleneck, KernelLaunchLatency,
    IntraNodeGpuSkew, PCIeLinkSaturation, GpuP2PThrottling,
    PinnedMemoryShortage, HostCpuBottleneck, MemoryRegistrationChurn,
    DecodeEarlyStopSkew,
    # 3(c)
    TPStraggler, PPBubble, CrossNodeLoadSkew, NetworkCongestion,
    HeadOfLineBlocking, EWRetransmitStorm, CreditStarvation,
    KVCacheTransferBottleneck, EarlyStopSkewAcrossNodes,
    # 3(d)
    CrossReplicaSkew, HierarchicalRoutingSkew,
    # 3(e)
    CollectiveStragglerLag, RailCongestion, HbmBandwidthCliff,
    # DPU self-diagnosis
    DPUSaturation,
    # monitoring-plane robustness
    DPUOutage, TelemetryBlackout, CommandPartition, StandbyLag,
    SplitBrainFenced,
)
