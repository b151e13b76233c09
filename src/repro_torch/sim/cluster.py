"""Discrete-event cluster simulator for pathology injection and validation.

Models an LLM inference cluster the way the paper's DPU sees it: every
request's lifecycle is rendered as the event sequence a NIC-inline / PCIe-peer
observer would record — ingress packets, H2D/D2H DMA bursts, dispatch
doorbells, TP collective bursts, PP stage handoffs, KV-cache migrations,
egress token packets, credit updates, queue-depth samples.

The simulator serves three purposes:
  1. *Per-row validation*: each runbook row has a fault injector
     (``sim.faults``); we assert the bound detector fires and attribution
     names the right locus.
  2. *Closed-loop evaluation* (§5): the sim implements ``EngineControls``;
     the mitigation controller's actions actually remove the fault effect,
     so throughput/latency deltas quantify the benefit.
  3. *Benchmark substrate* for Tables 3(a)/(b)/(c)/(d) and the sweep runner.

Event synthesis is columnar-native: each phase computes whole-round numpy
column arrays (timestamps, sizes, flows, retransmit masks via vectorized
Bernoulli draws) and hands them to ``EventBatchBuilder.add_columns`` — the
producer mirror of the PR-2 consumer plane.  ``SimParams.scalar_synth=True``
replays the *same* columns through per-row ``add`` calls (the per-event
reference path): both paths draw from one seeded ``np.random.Generator``
and stage rows in the same order, so they produce bit-identical batches —
detector-finding parity holds by construction and is pinned by the golden
per-scenario fixtures in ``tests/golden/``.

Fidelity notes: timing constants approximate a TP-sharded decode loop at a
2 ms step cadence.  The sim is NOT a queueing-theoretic model of a specific
fabric — it is a *signal generator* whose statistics carry the pathologies'
signatures (that is exactly the DPU's view: distributions of timestamps,
sizes, and gaps).
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.detectors import (
    META_BATCH_OCC,
    META_DIR_EGRESS,
    META_DIR_EW,
    META_DIR_INGRESS,
    META_FIN,
    META_KV_OCC,
    META_P2P_INTER,
    META_P2P_INTRA,
    META_P2P_KV,
    META_TAP_DEBUG,
)
from repro_torch.core.events import (
    COLL_EDGE_FINISH,
    COLL_EDGE_START,
    COLL_GROUP_ALL_GATHER,
    COLL_GROUP_REDUCE_SCATTER,
    DOMAIN_GROUP_BASE,
    RAIL_GROUP_BASE,
    CollectiveOp,
    EventBatchBuilder,
    EventKind,
)
from repro_torch.core.runbooks import DEFAULT_TABLES
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.dpu.sidecar import DPUParams, DPUSidecar
from repro_torch.dpu.transport import LinkParams, ModeledLink
from repro_torch.dpu.watchdog import Watchdog, WatchdogParams
from repro_torch.serving.router import (
    NodeSnapshot,
    ReplicaSnapshot,
    RequestInfo,
    Router,
)
from repro_torch.sim.workload import Request, WorkloadSpec, generate


@dataclass
class SimParams:
    n_nodes: int = 4
    n_replicas: int = 1              # DP replicas; nodes split evenly across
    router_policy: str = "round_robin"
    router_staleness: float = 0.0    # router view lag (healthy: 0 = fresh)
    devices_per_node: int = 4
    slots_per_node: int = 8          # max concurrent decode sequences
    kv_tokens_per_slot: int = 1024   # KV budget per slot (occupancy proxy)
    duration: float = 2.0
    decode_step: float = 2e-3        # healthy decode round cadence
    compute_frac: float = 0.35       # fraction of step before collective
    egress_frac: float = 0.75        # fraction of step when tokens egress
    mtu: int = 4096
    h2d_tok_bytes: int = 8192        # embedding bytes per prompt token
    d2h_tok_bytes: int = 1024        # logits/token id bytes per step
    egress_tok_bytes: int = 512
    collective_bytes: int = 1 << 21  # per node per round (TP all-reduce)
    p2p_intra_bytes: int = 1 << 19
    kv_page_bytes: int = 1 << 16
    queue_sample_every: float = 4e-3
    credit_every: float = 8e-3
    # True = healthy engine (vLLM-style continuous batching).  The early-stop
    # pathologies (paper: "no remap of freed resources") set this False.
    continuous_batching: bool = True
    seed: int = 0
    # True = per-event reference synthesis (same draws, row-at-a-time
    # emission); the golden-fixture parity tests pin vectorized == scalar
    scalar_synth: bool = False
    # flush the accumulated columns to the plane once this many rows are
    # staged.  Default 1 = flush every round (the detector-validated
    # cadence: batches delivered round-major, as the PR-2 consumer plane
    # expects).  Line-rate producer benchmarks raise this to ring-DMA
    # window sizes (e.g. 65536); the telemetry plane splits any batch at
    # poll boundaries either way.  With a mitigation controller attached
    # the sim flushes every round regardless, so actuation stays prompt.
    flush_events: int = 1
    # --- control-loop topology (repro_torch.dpu) ---
    # "auto"    -> "dpu" when run_scenario(mitigate=True), else "none"
    # "none"    -> detection plane attached directly, no actuation
    # "instant" -> legacy zero-latency in-process controller (golden parity)
    # "dpu"     -> DPUSidecar: modeled transport + budget + policy + bus
    control: str = "auto"
    dpu: DPUParams | None = None     # sidecar knobs when control == "dpu"
    # --- router-view transport (hierarchical router) ---
    # The router's view of the replicas rides a modeled link instead of a
    # direct in-process snapshot: None = a zero-latency lossless link
    # (bit-identical to direct attach, and it draws no randomness), real
    # LinkParams make the view lag/jitter/drop like the DPU uplink does.
    view_link: LinkParams | None = None
    # --- prefix-cache model (affinity-aware routing experiments) ---
    # When enabled, each node keeps a bounded LRU of session prefix keys;
    # a hit skips the cached share of prefill (shorter TTFT, smaller H2D),
    # a miss pays the full prefill penalty and evicts.  Off by default so
    # the canonical scenarios are untouched.
    prefix_cache: bool = False
    prefix_cache_sessions: int = 8   # per-node LRU capacity (sessions)
    prefill_tok_s: float = 5e-5      # prefill cost per prompt token (s)
    prefix_frac: float = 0.8         # prompt share a prefix hit skips
    # --- per-collective emission tier (Table 3e) ---
    # When enabled, the aggregate TP burst (group 0) is joined by explicit
    # all-gather / reduce-scatter ops, each rendered as per-node start and
    # finish edges so per-op skew is a first-class observable.  Off by
    # default so the canonical scenarios are untouched; all randomness for
    # the tier comes from a dedicated stream (``seed ^ 0xCA11``).
    per_collective: bool = False
    coll_ag_bytes: int = 1 << 20     # all-gather wire bytes per node per op
    coll_rs_bytes: int = 1 << 20     # reduce-scatter wire bytes (every 2nd)
    # --- rail / NVLink-domain topology tier (DWDP-style) ---
    # Nodes per fast intra-domain tier; 0 disables the tier entirely.
    # Cross-domain legs ride a shared rail (``node % rail_count``), which
    # makes rail congestion a fault axis distinct from any single node.
    rail_domain_size: int = 0
    rail_count: int = 2
    # --- memory-bandwidth saturation knee (decode phase) ---
    # Active decode batch size past which a node's token rate saturates:
    # the node completes only a ``knee / batch`` duty cycle of egress
    # rounds (throughput cliff with flat queues).  0 disables the model.
    hbm_knee: int = 0
    # --- monitoring-plane failover (repro_torch.dpu.watchdog) ---
    # When set (and control resolves to "dpu"), the sidecar is wrapped in a
    # host-side Watchdog: heartbeat/ack supervision over the OOB management
    # port, degraded fallback controller on failover.  None = no watchdog,
    # bit-identical to the plain sidecar topology.
    watchdog: "WatchdogParams | None" = None
    # --- hot standby sidecar (repro_torch.dpu.election) ---
    # When set (requires watchdog), a second DPUSidecar shadows the same
    # tap through a TapFanout over its own modeled uplink, and the watchdog
    # is promoted to lease arbiter: primary dark -> hot promotion of the
    # warm standby; both dark -> degraded host mode.  None = no standby,
    # bit-identical to the single-sidecar topology.
    standby: DPUParams | None = None
    # --- observability (repro_torch.obs) ---
    # When True, run_scenario threads one shared Tracer + FlightRecorder
    # through every control-loop stage (findings, attribution, policy,
    # bus, actuation, watchdog/election transitions) and exposes it as
    # ``sim.tracer``.  Strictly observe-only: zero RNG draws, no event
    # mutation — findings are bit-identical with this on or off (the
    # golden-parity guard in tests/test_obs.py asserts it).
    trace: bool = False


@dataclass
class FaultSpec:
    """Knobs a fault injector can turn.  All default to healthy values."""

    name: str = "healthy"
    row_id: str = ""                   # runbook row this fault realizes
    start: float = 0.8                 # activation time (baseline warmup)
    # --- north-south ---
    ingress_starve_node: int = -1      # node whose ingress dries up
    ingress_retx_p: float = 0.0
    egress_retx_p: float = 0.0
    ew_retx_p: float = 0.0
    egress_jitter_mult: float = 1.0
    egress_backlog_rate: float = 0.0   # queue growth per round
    nic_background_frac: float = 0.0   # extra NIC load as frac of capacity
    # --- pcie ---
    h2d_stall_node: int = -1           # node whose device feed stalls
    h2d_stall_mult: float = 10.0
    h2d_split: int = 1                 # split every H2D into n tiny DMAs
    d2h_delay_mult: float = 1.0
    dispatch_jitter_mult: float = 1.0
    dispatch_delay: float = 0.0
    skew_device: tuple[int, int] | None = None   # (node, device) starved
    skew_factor: float = 0.15          # starved device's share multiplier
    pcie_background_frac: float = 0.0
    p2p_slow_node: int = -1
    reg_churn: bool = False
    host_slow_node: int = -1           # CPU-bottlenecked node
    # --- east-west ---
    straggler_node: int = -1
    straggler_delay: float = 0.0       # added collective delay (s)
    collective_bytes_node: int = -1    # node that oversends
    collective_bytes_mult: float = 1.0
    stage_gap_growth: float = 0.0      # PP handoff gap growth per round (s)
    fabric_jitter: float = 0.0         # stddev added to all E-W arrivals (s)
    hol_stall_frac: float = 0.0        # fraction of flows stalled in bursts
    credit_starve: bool = False
    kv_heavy: bool = False
    node_stop: int = -1                # node that exits mid-iteration
    node_stop_at: float = 1.2
    # --- data-parallel routing (Table 3d) ---
    hot_replica: int = -1              # replica that affinity pins flows onto
    hot_replica_frac: float = 0.6      # fraction of flows pinned when active
    router_stale: float = 0.0          # view-link delay injected (s): while
    #                                    active the router's view transport
    #                                    runs at this latency (plus jitter
    #                                    and loss), instead of the healthy
    #                                    configured link
    replica_slow: int = -1             # replica whose nodes decode slowly
    replica_slow_mult: float = 4.0     # slow replica runs every k-th round
    # intra-replica placement skew: each replica's requests are pinned onto
    # its first node with this probability (a replica-local scheduler
    # affinity bug) — replica totals stay balanced while nodes inside
    # every replica skew, the hierarchical_routing_skew signature
    intra_replica_pin_frac: float = 0.0
    # --- per-collective / rail / memory-knee tier (Table 3e) ---
    collective_lag_node: int = -1      # node whose per-op finishes lag
    collective_lag: float = 0.0        # added per-op finish delay (s)
    rail_cut: int = -1                 # rail whose bandwidth is cut
    rail_cut_mult: float = 1.0         # cross-domain leg slowdown on it
    hbm_knee_shift: int = 0            # knee shrinks to this while active
    # --- workload shaping ---
    early_stop_skew: bool = False      # extreme decode-length divergence
    # --- telemetry-plane load (DPU self-diagnosis) ---
    telemetry_flood: float = 0.0       # extra debug-tap rows per round
    # --- monitoring-plane chaos (mon table) ---
    # These knobs break the *monitoring plane itself* rather than the
    # cluster: they are merged into DPUParams/LinkParams by run_scenario
    # (only when set, so canonical scenarios stay bit-identical) and the
    # partition windows are pure clock comparisons — zero RNG draws.
    dpu_crash_at: float = -1.0         # sidecar crash time (<0 = never)
    dpu_restart_after: float = 0.0     # warm-restart delay (0 = stays down)
    uplink_blackout_start: float = -1.0  # telemetry uplink partition window
    uplink_blackout_s: float = 0.0
    downlink_partition_start: float = -1.0  # command-channel partition
    downlink_partition_s: float = 0.0
    uplink_corrupt_p: float = 0.0      # per-batch bit-rot probability
    uplink_duplicate_p: float = 0.0    # per-batch replay probability
    # --- hot-standby chaos (election / split-brain axes) ---
    # These target the *redundant* half of the monitoring plane: the
    # standby's own uplink copy of the tap, the standby card itself, and
    # the OOB management port the lease renewals ride.  All are pure
    # clock-window comparisons merged only when set — zero RNG draws.
    standby_blackout_start: float = -1.0  # standby uplink partition window
    standby_blackout_s: float = 0.0
    standby_crash_at: float = -1.0     # standby card crash (<0 = never)
    standby_restart_after: float = 0.0
    oob_partition_start: float = -1.0  # OOB port partition (heartbeat +
    oob_partition_s: float = 0.0       # lease renewals both dark inside)
    # --- intermittency ---
    # > 0: the fault is only active during alternating windows of this
    # length (fire/clear/fire...) — the oscillation that exercises the
    # policy engine's flap damping
    osc_period: float = 0.0

    mitigated: bool = False            # controller flips this

    def active(self, t: float) -> bool:
        if t < self.start or self.mitigated:
            return False
        if self.osc_period > 0.0:
            return int((t - self.start) / self.osc_period) % 2 == 0
        return True


@dataclass
class SimMetrics:
    completed: int = 0
    latencies: list = field(default_factory=list)
    ttfts: list = field(default_factory=list)   # queue wait + first step
    tokens_out: int = 0
    slot_rounds_busy: int = 0
    slot_rounds_idle: int = 0          # idle WHILE queue nonempty (waste)
    first_finding_ts: float = -1.0     # bound finding's own (event) ts
    detect_wall_ts: float = -1.0       # host round when the loop SAW it
    first_action_ts: float = -1.0      # host round of the first actuation
    mitigated_ts: float = -1.0         # host round the fault was neutralized
    actions_applied: list = field(default_factory=list)
    prefix_hits: int = 0               # prefill prefix-cache hits (model on)
    prefix_misses: int = 0

    def p(self, q: float) -> float:
        # NaN-safe: tiny smoke configs may complete nothing; benchmark rows
        # must render 0.0 rather than crash or propagate NaN
        if not self.latencies:
            return 0.0
        s = sorted(self.latencies)
        return s[min(int(q * len(s)), len(s) - 1)]

    def p_ttft(self, q: float) -> float:
        if not self.ttfts:
            return 0.0
        s = sorted(self.ttfts)
        return s[min(int(q * len(s)), len(s) - 1)]

    def throughput(self, duration: float) -> float:
        if duration <= 0.0:
            return 0.0
        return self.tokens_out / duration

    def idle_frac(self) -> float:
        tot = self.slot_rounds_busy + self.slot_rounds_idle
        return self.slot_rounds_idle / tot if tot else 0.0


#: rows of the per-node active-request mirror array
MIR_FLOW, MIR_DEC, MIR_PROMPT, MIR_DEV, MIR_REM = range(5)


class ClusterSim:
    """Round-driven simulator; implements EngineControls for the closed loop.

    The hot path is phase-major: each round, every emission phase computes
    its column arrays across ALL nodes at once and appends them in one
    ``add_columns`` call.  Request/queue bookkeeping (admission, slot
    refill, completion) stays scalar — it is a few dozen objects per round —
    while the event volume (tens of thousands of rows per second of sim
    time) never touches per-row Python on the vectorized path.
    """

    def __init__(self, params: SimParams, workload: WorkloadSpec,
                 fault: FaultSpec | None = None,
                 plane: TelemetryPlane | None = None) -> None:
        if params.n_nodes % params.n_replicas != 0:
            raise ValueError(
                f"n_nodes={params.n_nodes} not divisible by "
                f"n_replicas={params.n_replicas}")
        self.p = params
        self.fault = fault or FaultSpec()
        self.plane = plane
        # one seeded Generator feeds BOTH synthesis paths: the scalar
        # reference replays the vectorized draws row-by-row, so parity
        # never depends on matching two RNG implementations
        self.rng = np.random.default_rng(params.seed ^ 0xD0)
        self.scalar_synth = params.scalar_synth
        self.requests = generate(workload)
        if self.fault.early_stop_skew:
            self._skew_decode_lengths()
        # arrival-sorted admission backlog consumed by an index cursor
        # (a pop(0) list is O(n^2) across a bursty run)
        self.pending: list[Request] = sorted(self.requests,
                                             key=lambda r: r.arrival)
        self._pend_i = 0
        self.queues: list[deque[Request]] = [deque()
                                             for _ in range(params.n_nodes)]
        # incrementally-maintained sum(max(decode_len,1)) per queue so the
        # router view refresh is O(replicas), not O(queued requests)
        self._queued_work: list[int] = [0] * params.n_nodes
        self.active: list[list[Request]] = [[] for _ in range(params.n_nodes)]
        # SoA mirrors of the active lists (index-aligned): the decode-round
        # hot path reads/updates these as whole arrays; the Request objects
        # only back completion metadata.  ``_act_tok`` is authoritative for
        # in-flight token counts (synced back to objects on completion and
        # at end of run).
        n_nodes = params.n_nodes
        # one (5, n_active) int64 array per node; rows are MIR_* below.
        # Token accounting is lazy: the REM row holds remaining-token
        # counts as of the last fold; ``_tok_off`` counts egress rounds
        # since then (true remaining = rem - off).  ``_rem_min`` gates the
        # completion scan so the common no-completion round costs zero
        # numpy; ``_kv_base`` caches sum(prompt + consumed-at-fold) so KV
        # occupancy is O(1) per sample.
        self._mir = [np.empty((5, 0), np.int64) for _ in range(n_nodes)]
        self._mver = 0            # membership version (cache invalidation)
        self._tok_off = [0] * n_nodes
        self._rem_min = [1 << 60] * n_nodes
        self._kv_base = [0] * n_nodes
        # fused per-round column templates (rebuilt when membership or the
        # running-node set changes)
        self._eg_key = None
        self._eg_tmpl: dict | None = None
        self._disp_key = None
        self._disp_tmpl: tuple | None = None
        self._rt_key = None
        self._rt_tmpl: tuple | None = None
        self._nic_key = None
        self._nic_tmpl: tuple | None = None
        # live per-device sequence counts (drives placement, doorbells, D2H)
        self._dev_count = [[0] * params.devices_per_node
                           for _ in range(n_nodes)]
        # sorted (node, device) pairs with live sequences + parallel D2H
        # byte sizes, maintained incrementally (bisect) so doorbell/D2H
        # columns never need a full node x device scan per round
        self._pairs: list[tuple[int, int]] = []
        self._pair_sizes: list[int] = []
        self._pairs_dirty = True
        self._pairs_node = np.empty(0, np.int64)
        self._pairs_dev = np.empty(0, np.int64)
        self._pairs_off = np.empty(0, np.float64)
        self._ar_eg = np.arange(params.slots_per_node) * 2e-6
        self.batch_open: list[bool] = [True] * params.n_nodes
        self.metrics = SimMetrics()
        self.round = 0
        self._next_queue_sample = 0.0
        self._next_credit = 0.0
        self._egress_backlog = [0.0] * params.n_nodes
        self._pp_extra_gap = 0.0
        # columnar emission: phases record column chunks into a deferred
        # accumulator; flushes merge them per kind into one builder whose
        # batch goes to the plane at ring-DMA granularity
        self._batch = EventBatchBuilder()
        self._acc: list[tuple] = []
        self._acc_rows = 0
        self._continuous = params.continuous_batching
        # prefill H2D specs collected during slot refill, emitted per round
        self._pref_ts: list[float] = []
        self._pref_nodes: list[int] = []
        self._pref_devs: list[int] = []
        self._pref_bytes: list[int] = []
        self._pref_flows: list[int] = []
        # cached constant column templates (node/device/flow grids repeat
        # every round; add_columns adopts them read-only)
        self._tmpl_h2d: dict[tuple, tuple] = {}
        self._tmpl_pp: dict[tuple, tuple] = {}
        self._tmpl_p2p: dict[tuple, tuple] = {}
        self._tmpl_kv: dict[tuple, tuple] = {}
        self._tmpl_sample: dict[int, tuple] = {}
        self._all_nodes = np.arange(params.n_nodes, dtype=np.int64)
        fa = self.fault
        self._h2d_knobs = (fa.skew_device is not None or fa.h2d_split > 1
                           or fa.reg_churn or fa.pcie_background_frac > 0)
        # --- data-parallel replica dimension ---
        self.nodes_per_replica = params.n_nodes // params.n_replicas
        self._replica_ids = np.arange(params.n_replicas, dtype=np.int64)
        self._replica_lo = self._replica_ids * self.nodes_per_replica
        self.router = Router(params.n_replicas,
                             policy=params.router_policy,
                             staleness=params.router_staleness,
                             seed=params.seed)
        self._replica_rr = [0] * params.n_replicas
        # the router's view rides a modeled link (telemetry-borne view):
        # the default zero-latency lossless link is bit-identical to direct
        # attach and draws no randomness; the link has its OWN seeded
        # stream so a jittery/lossy view never perturbs the synthesis RNG
        # (scalar/columnar parity is per-draw)
        # view snapshots are idempotent last-writer-wins datagrams, not a
        # sequenced stream: out-of-order arrival (view flapping) is part
        # of the channel being modeled, so ordering stays off
        self._view_base = dataclasses.replace(
            params.view_link or LinkParams(delay=0.0), ordered=False)
        self._view_link = ModeledLink(
            self._view_base, np.random.default_rng(params.seed ^ 0x51EF))
        # per-node prefix caches (session key -> LRU marker) and the
        # serialized prefill unit each node runs admissions through: a
        # miss occupies it for the full prompt's prefill time, a hit only
        # for the uncached share — cache thrash costs admission capacity,
        # which is why affinity routing moves the TTFT tail
        self._pfx: list[dict[int, bool]] | None = (
            [{} for _ in range(n_nodes)] if params.prefix_cache else None)
        self._pfx_busy = [0.0] * n_nodes
        # --- asynchronous control plane (repro_torch.dpu) ---
        # a plane with an ``advance`` hook is a DPU sidecar: the host loop
        # pumps its cycle once per round (uplink delivery, budget drain,
        # policy decisions, command/ack exchange)
        self._ctrl = plane if hasattr(plane, "advance") else None
        # shared Tracer (repro_torch.obs) when params.trace; attached by
        # run_scenario after construction.  Observe-only.
        self.tracer = None
        self.recorder = None
        self._t = 0.0                  # current round's host-clock time
        self._flood = self.fault.telemetry_flood > 0
        self._flood_tmpl: tuple | None = None
        # --- per-collective / rail / memory-knee tier (Table 3e) ---
        # dedicated stream: enabling the tier must never perturb the legacy
        # synthesis draws (the canonical golden fixtures are bit-identical
        # whether or not these knobs exist)
        self.rng_coll = np.random.default_rng(params.seed ^ 0xCA11)
        self._slot_cap = params.slots_per_node   # shrink_batch actuation
        self._rail_reroute = False               # reroute_rail actuation
        self._hbm_credit = [0.0] * n_nodes       # duty-cycle accumulator

    # ------------------------------------------------------------------
    # EngineControls
    # ------------------------------------------------------------------

    def apply_action(self, action: str, node: int, detail: dict) -> bool:
        """Mitigation actuation: matching action neutralizes the fault."""
        m = self.metrics
        if m.first_action_ts < 0:
            m.first_action_ts = self._t
        m.actions_applied.append((action, node))
        from repro_torch.core.runbooks import BY_ID
        entry = BY_ID.get(self.fault.row_id)
        matched = entry is not None and entry.action == action
        newly = matched and not self.fault.mitigated
        if matched:
            if not self.fault.mitigated:
                m.mitigated_ts = self._t
            self.fault.mitigated = True
        if self.tracer is not None:
            # recovery confirmation: the apply that flips ``mitigated``
            # closes the open incident and pins its TTM milestones
            self.tracer.on_apply(action, node, self._t, matched, newly)
        # actions with a concrete actuation in the sim help regardless of
        # whether they were the prescribed row action
        if action == "inflight_remap":
            self._continuous = True  # enable continuous batching
            return True
        if action == "rebalance_replicas":
            self._rebalance_replicas()
            return True
        if action == "rebalance_nodes":
            self._rebalance_nodes()
            return True
        if action == "shrink_batch":
            # halve the decode batch-slot cap: the active batch drains back
            # below the memory-bandwidth knee as sequences complete
            self._slot_cap = max(1, self._slot_cap // 2)
            return True
        if action == "reroute_rail":
            # hot-rail bypass: cross-domain legs round-robin over all rails
            # instead of riding their home rail
            self._rail_reroute = True
            return True
        if action == "resync_telemetry":
            # re-register the tap: the sidecar's ingest guard drops its
            # blackout latch once the host confirms the stream is whole
            ctrl = self._ctrl
            if ctrl is not None and hasattr(ctrl, "resync"):
                ctrl.resync(self._t)
                return True
            return matched
        if action == "failover_controller":
            # hand control to the host-side degraded loop (idempotent when
            # the watchdog already failed over on its own)
            ctrl = self._ctrl
            if ctrl is not None and hasattr(ctrl, "force_failover"):
                ctrl.force_failover(self._t)
                return True
            return matched
        if action == "remirror_standby":
            # replay the watchdog's retained tap window into the lagging
            # standby and resync its sequence stream
            ctrl = self._ctrl
            if ctrl is not None and hasattr(ctrl, "remirror"):
                return ctrl.remirror(self._t) or matched
            return matched
        if action == "fence_stale_controller":
            # deliver the granted term to any deposed-but-alive sidecar so
            # its stale command stream quiesces at the source
            ctrl = self._ctrl
            if ctrl is not None and hasattr(ctrl, "fence_stale"):
                return ctrl.fence_stale(self._t) or matched
            return matched
        return matched

    def _rebalance_replicas(self) -> None:
        """Redistribute queued requests evenly across all nodes (the DP
        rebalance actuation: drain the hot replica's backlog into its
        peers' free capacity)."""
        backlog: list[Request] = []
        for q in self.queues:
            backlog.extend(q)
            q.clear()
        backlog.sort(key=lambda r: r.arrival)
        self._queued_work = [0] * self.p.n_nodes
        for i, r in enumerate(backlog):
            node = i % self.p.n_nodes
            r.node = node
            self.queues[node].append(r)
            self._queued_work[node] += max(r.decode_len, 1)

    def _rebalance_nodes(self) -> None:
        """Level queued requests across the nodes *inside* each replica —
        the intra-replica actuation for hierarchical routing skew (the
        replica tier is untouched: no request changes replica)."""
        npr = self.nodes_per_replica
        for rep in range(self.p.n_replicas):
            lo = rep * npr
            backlog: list[Request] = []
            for n in range(lo, lo + npr):
                backlog.extend(self.queues[n])
                self.queues[n].clear()
                self._queued_work[n] = 0
            backlog.sort(key=lambda r: r.arrival)
            for i, r in enumerate(backlog):
                node = lo + i % npr
                r.node = node
                self.queues[node].append(r)
                self._queued_work[node] += max(r.decode_len, 1)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def run(self) -> SimMetrics:
        t = 0.0
        p = self.p
        # a live controller must see findings the round they happen —
        # closed-loop actuation timing is part of the experiment
        per_round = (self.plane is not None
                     and getattr(self.plane, "controller", None) is not None)
        flush_events = max(int(p.flush_events), 1)
        ctrl = self._ctrl
        while t < p.duration:
            self._t = t
            self._admit(t)
            self._sample_queues(t)
            self._decode_round(t)
            self._credits(t)
            if self._flood:
                self._flood_phase(t)
            if self.plane is not None and (
                    per_round or self._acc_rows >= flush_events):
                self._flush()
            if ctrl is not None:
                # the DPU's cycle: delayed telemetry lands, budget-paced
                # detection runs, commands/acks cross the wire
                ctrl.advance(t)
                self._note_first_finding()
            self.round += 1
            t += p.decode_step
        self._t = t
        if self.plane is not None:
            self._flush()
        if ctrl is not None:
            ctrl.advance(t)
            self._note_first_finding()
        # mirrors are authoritative for in-flight token counts; sync the
        # objects so post-run inspection sees consistent state
        for nd in range(p.n_nodes):
            self._fold_tokens(nd)
            mir = self._mir[nd]
            rem = mir[MIR_REM].tolist()
            dec = mir[MIR_DEC].tolist()
            for i, r in enumerate(self.active[nd]):
                r.tokens_out = dec[i] - rem[i]
        return self.metrics

    def _flush(self) -> None:
        self._assemble()
        if len(self._batch) == 0:
            return
        self.plane.observe_batch(self._batch.build(sort=True))
        self._batch.clear()
        self._note_first_finding()

    def _note_first_finding(self) -> None:
        if self.metrics.first_finding_ts < 0 and self.plane.findings:
            for f in self.plane.findings:
                if f.name == self.fault.row_id:
                    self.metrics.first_finding_ts = f.ts
                    self.metrics.detect_wall_ts = self._t
                    break

    # ------------------------------------------------------------------
    # columnar emission core
    # ------------------------------------------------------------------

    def _emit_cols(self, ts, kind: EventKind, node=0, device=-1, flow=-1,
                   size=0, depth=0, op=-1, group=-1, meta=0,
                   replica=-1) -> None:
        """Record one phase-call's columns (``ts`` array + array/scalar
        columns).  Emission is deferred: calls accumulate per flush window
        and are merged per event kind at assemble time, so the builder
        sees one chunk per kind per window instead of one per phase-round.
        """
        if type(ts) is tuple:
            n = ts[1]      # (scalar_ts, count): broadcast at assemble time
        else:
            if type(ts) is not np.ndarray:
                ts = np.asarray(ts, np.float64)
            n = ts.shape[0]
        if n == 0:
            return
        self._acc.append((int(kind), ts, (node, device, flow, size, depth,
                                          op, group, meta, replica)))
        self._acc_rows += n

    def _assemble(self) -> None:
        """Merge the accumulated phase calls into builder chunks.

        Calls are grouped by event kind (group order = first occurrence,
        i.e. the fixed per-round phase sequence); within a group, call
        order is kept.  The scalar_synth reference path replays the same
        grouped sequence through per-row ``add`` calls, so both paths
        stage identical rows in identical order — bit-identical batches
        after the stable time sort.
        """
        acc = self._acc
        if not acc:
            return
        groups: dict[int, list] = {}
        for call in acc:
            g = groups.get(call[0])
            if g is None:
                groups[call[0]] = g = []
            g.append(call)
        acc.clear()
        self._acc_rows = 0
        scalar = self.scalar_synth
        for kind, calls in groups.items():
            if scalar:
                self._replay_rows(kind, calls)
            elif len(calls) == 1:
                _, ts, vals = calls[0]
                if type(ts) is tuple:
                    ts = np.full(ts[1], ts[0])
                self._batch.add_columns(ts, kind, *vals)
            else:
                self._merge_calls(kind, calls)

    def _merge_calls(self, kind: int, calls: list) -> None:
        sizes = [ts[1] if type(ts) is tuple else ts.shape[0]
                 for _, ts, _ in calls]
        total = sum(sizes)
        ts0 = calls[0][1]
        if type(ts0) is not tuple and all(
                type(c[1]) is not tuple for c in calls[1:]):
            ts_col = np.concatenate([c[1] for c in calls])
        else:
            ts_col = np.empty(total, np.float64)
            pos = 0
            for n, c in zip(sizes, calls):
                v = c[1]
                ts_col[pos:pos + n] = v[0] if type(v) is tuple else v
                pos += n
        merged = [None] * 9
        sizes_a = None
        for i in range(9):
            first = calls[0][2][i]
            if type(first) is np.ndarray:
                parts = []
                pure = True
                for c in calls:
                    v = c[2][i]
                    if type(v) is not np.ndarray:
                        pure = False
                        break
                    parts.append(v)
                if pure:
                    merged[i] = np.concatenate(parts)
                    continue
            else:
                mixed = False
                uniform = True
                for c in calls:
                    v = c[2][i]
                    if type(v) is np.ndarray:
                        mixed = True
                        break
                    if v != first:
                        uniform = False
                if not mixed:
                    if uniform:
                        merged[i] = int(first)  # broadcast at build time
                    else:
                        if sizes_a is None:
                            sizes_a = np.asarray(sizes, np.int64)
                        merged[i] = np.repeat(np.asarray(
                            [int(c[2][i]) for c in calls], np.int64),
                            sizes_a)
                    continue
            # mixed arrays and scalars: segment-fill (rare — only when one
            # kind is fed by producers of different shapes in one window)
            out = np.empty(total, np.int64)
            pos = 0
            for n, c in zip(sizes, calls):
                out[pos:pos + n] = c[2][i]
                pos += n
            merged[i] = out
        self._batch.add_columns(ts_col, kind, *merged)

    def _replay_rows(self, kind: int, calls: list) -> None:
        # the per-event reference path: same rows, same order, one add()
        # per event (what the pre-columnar producer paid per packet)
        add = self._batch.add
        for _, ts, vals in calls:
            if type(ts) is tuple:
                ts_l = [ts[0]] * ts[1]
            else:
                ts_l = ts.tolist()
            n = len(ts_l)
            cols = [v.tolist() if type(v) is np.ndarray else None
                    for v in vals]
            consts = [0 if c is not None else int(v)
                      for v, c in zip(vals, cols)]
            for i in range(n):
                add(ts_l[i], kind,
                    *(c[i] if c is not None else s
                      for c, s in zip(cols, consts)))

    # ------------------------------------------------------------------
    # request admission / ingress path
    # ------------------------------------------------------------------

    def _skew_decode_lengths(self) -> None:
        # randomized so stragglers land on every node (a modular pattern
        # would alias with round-robin placement)
        rng = np.random.default_rng(0xBEEF)
        long_mask = rng.random(len(self.requests)) < 0.25
        for r, is_long in zip(self.requests, long_mask.tolist()):
            r.decode_len = 400 if is_long else 8

    def _replica_of(self, node: int) -> int:
        return node // self.nodes_per_replica

    def _node_for(self, r: Request, t: float) -> int:
        """Route a request: replica choice via the router, then a node
        slot.  Hierarchical policies place the node themselves (two-stage
        choose); flat policies fall back to a round-robin spread over the
        replica's nodes (its TP group), the flat-router behavior."""
        p, f = self.p, self.fault
        node = -1
        if (f.active(t) and f.hot_replica >= 0
                and self.rng.random() < f.hot_replica_frac):
            # session-affinity pinning overrides the policy (the fault)
            replica = f.hot_replica % p.n_replicas
            self.router.routed_per_replica[replica] += 1
        else:
            decision = self.router.route_ex(RequestInfo(
                flow=r.flow, prompt_len=r.prompt_len,
                predicted_decode=float(r.decode_len),
                session=r.session), now=t)
            replica, node = decision.replica, decision.node
        if node < 0:
            self._replica_rr[replica] += 1
            local = self._replica_rr[replica] % self.nodes_per_replica
            node = replica * self.nodes_per_replica + local
        if (f.intra_replica_pin_frac > 0 and f.active(t)
                and self.rng.random() < f.intra_replica_pin_frac):
            # replica-local affinity bug: the request sticks to the
            # replica's first node regardless of the router's spread
            node = self._replica_of(node) * self.nodes_per_replica
        return node

    def _admit(self, t: float) -> None:
        f = self.fault
        pend = self.pending
        i, n = self._pend_i, len(pend)
        if i >= n or pend[i].arrival > t:
            return
        starve = f.ingress_starve_node if f.active(t) else -1
        admitted: list[Request] = []
        while i < n and pend[i].arrival <= t:
            r = pend[i]
            i += 1
            node = self._node_for(r, t)
            if node == starve:
                # upstream dried up: this node's share silently vanishes
                continue
            r.node = node
            self.queues[node].append(r)
            self._queued_work[node] += max(r.decode_len, 1)
            admitted.append(r)
        self._pend_i = i
        if admitted:
            self._ingress_phase(t, admitted)

    def _ingress_phase(self, t: float, admitted: list[Request]) -> None:
        p, f = self.p, self.fault
        k = len(admitted)
        retx_on = f.ingress_retx_p > 0.0 and not f.mitigated
        if k <= 4:
            # steady-state rounds admit a request or two: plain Python
            # beats array setup at this size (draw structure stays
            # per-request, shared by both synthesis paths)
            floor_ts = t - p.decode_step
            ts_l: list[float] = []
            node_l: list[int] = []
            flow_l: list[int] = []
            size_l: list[int] = []
            rt_ts: list[float] = []
            rt_node: list[int] = []
            rt_flow: list[int] = []
            for r in admitted:
                nbytes = r.prompt_len * 2   # token ids on the wire
                npkt = (nbytes + p.mtu - 1) // p.mtu
                if npkt > 8:
                    npkt = 8
                base = r.arrival if r.arrival > floor_ts else floor_ts
                u = self.rng.random(npkt).tolist()
                sz = nbytes if nbytes < p.mtu else p.mtu
                for j in range(npkt):
                    ts_l.append(base + j * 2e-5 + u[j] * 1e-5)
                    node_l.append(r.node)
                    flow_l.append(r.flow)
                    size_l.append(sz)
                if retx_on:
                    u2 = self.rng.random(npkt).tolist()
                    for j in range(npkt):
                        ts_j = ts_l[j - npkt]
                        if ts_j >= f.start and u2[j] < f.ingress_retx_p:
                            rt_ts.append(ts_j + 5e-4)
                            rt_node.append(r.node)
                            rt_flow.append(r.flow)
            if k == 1:
                r = admitted[0]
                self._emit_cols(np.asarray(ts_l), EventKind.INGRESS_PKT,
                                node=r.node, flow=r.flow, size=size_l[0],
                                group=r.node)
            else:
                node_a = np.asarray(node_l, np.int64)
                self._emit_cols(np.asarray(ts_l), EventKind.INGRESS_PKT,
                                node=node_a, flow=np.asarray(flow_l,
                                                             np.int64),
                                size=np.asarray(size_l, np.int64),
                                group=node_a)
            if rt_ts:
                self._emit_cols(np.asarray(rt_ts), EventKind.RETRANSMIT,
                                node=np.asarray(rt_node, np.int64),
                                flow=np.asarray(rt_flow, np.int64),
                                size=p.mtu, meta=META_DIR_INGRESS)
            return
        nbytes = np.fromiter((r.prompt_len for r in admitted),
                             np.int64, k) * 2    # token ids on the wire
        npkt = np.clip(-(-nbytes // p.mtu), 1, 8)
        base = np.maximum(
            np.fromiter((r.arrival for r in admitted), np.float64, k),
            t - p.decode_step)
        nodes = np.fromiter((r.node for r in admitted), np.int64, k)
        flows = np.fromiter((r.flow for r in admitted), np.int64, k)
        total = int(npkt.sum())
        rep = np.repeat(np.arange(k), npkt)
        ends = np.cumsum(npkt)
        j = np.arange(total) - np.repeat(ends - npkt, npkt)
        ts = base[rep] + j * 2e-5 + self.rng.random(total) * 1e-5
        node_e, flow_e = nodes[rep], flows[rep]
        self._emit_cols(ts, EventKind.INGRESS_PKT, node=node_e, flow=flow_e,
                        size=np.minimum(nbytes, p.mtu)[rep], group=node_e)
        if retx_on:
            m = (ts >= f.start) & (self.rng.random(total) < f.ingress_retx_p)
            if m.any():
                self._emit_cols(ts[m] + 5e-4, EventKind.RETRANSMIT,
                                node=node_e[m], flow=flow_e[m], size=p.mtu,
                                meta=META_DIR_INGRESS)

    def _sample_queues(self, t: float) -> None:
        p, f = self.p, self.fault
        if t < self._next_queue_sample:
            return
        self._next_queue_sample = t + p.queue_sample_every
        n = p.n_nodes
        if f.active(t) and f.egress_backlog_rate > 0:
            r = f.egress_backlog_rate
            self._egress_backlog = [b + r for b in self._egress_backlog]
        else:
            self._egress_backlog = [b - 2.0 if b > 2.0 else 0.0
                                    for b in self._egress_backlog]
        jitter = f.active(t) and f.fabric_jitter > 0
        rows = 3 if jitter else 2
        tmpl = self._tmpl_sample.get(rows)
        if tmpl is None:
            nodes = np.arange(n, dtype=np.int64)
            reps = nodes // self.nodes_per_replica
            rep_c = np.empty((n, rows), np.int64)
            rep_c[:, 0] = reps
            rep_c[:, 1] = reps
            meta_row = [META_DIR_INGRESS, META_DIR_EGRESS]
            if jitter:
                rep_c[:, 2] = -1
                meta_row.append(2)
            tmpl = (np.repeat(nodes, rows),
                    np.tile(np.asarray(meta_row, np.int64), n),
                    rep_c.ravel())
            self._tmpl_sample[rows] = tmpl
        node_c, meta_c, rep_c = tmpl
        # per-node interleave [ingress, egress(, jitter)] exactly as the
        # scalar sim emitted them, so equal-ts stable order is preserved
        depth_c = np.empty((n, rows), np.int64)
        depth_c[:, 0] = [len(q) for q in self.queues]
        depth_c[:, 1] = self._egress_backlog
        if jitter:
            depth_c[:, 2] = 20 + self.rng.integers(20, size=n)
        self._emit_cols((t, n * rows), EventKind.QUEUE_SAMPLE,
                        node=node_c, depth=depth_c.ravel(),
                        meta=meta_c, replica=rep_c)
        if p.hbm_knee > 0:
            # scheduler-exported active batch occupancy per node — the
            # NIC-side tap the memory-knee detector correlates with the
            # token-rate sag (same vantage as the queue samples above)
            self._emit_cols((t, n), EventKind.QUEUE_SAMPLE,
                            node=self._all_nodes,
                            depth=np.asarray(
                                [len(a) for a in self.active], np.int64),
                            meta=META_BATCH_OCC)
        self._refresh_router(t)

    def _refresh_router(self, t: float) -> None:
        """Publish the router's view over the modeled link + emit the
        router-visible KV telemetry.

        The view is telemetry-borne: per-replica snapshot trees (with the
        per-node tier) are *sent* here and only reach the router when the
        link delivers them, so staleness is a measured property of the
        transport.  The stale-router-view fault degrades the link (delay +
        jitter + loss) while active; mitigation (or fault expiry) restores
        the healthy configured link.
        """
        p, f = self.p, self.fault
        if f.router_stale > 0:
            self._view_link.params = (
                LinkParams(delay=f.router_stale,
                           jitter=0.25 * f.router_stale, drop_p=0.05,
                           ordered=False)
                if f.active(t) else self._view_base)
        # fused decode-work estimate: one clamped subtraction over the
        # cluster-wide remaining-token concat instead of per-node reductions
        if self._rt_key != self._mver:
            counts = [self._mir[nd].shape[1] for nd in range(p.n_nodes)]
            self._rt_tmpl = (np.asarray(counts, np.int64), counts,
                             np.concatenate([self._mir[nd][MIR_REM]
                                             for nd in range(p.n_nodes)]))
            self._rt_key = self._mver
        counts_a, counts_l, rem_all = self._rt_tmpl
        if rem_all.shape[0]:
            off_rep = np.repeat(np.asarray(self._tok_off, np.int64),
                                counts_a)
            w_all = np.maximum(rem_all - off_rep, 1)
        else:
            w_all = rem_all
        occ_l: list[int] = []
        cap = self.nodes_per_replica * p.slots_per_node * p.kv_tokens_per_slot
        node_cap = p.slots_per_node * p.kv_tokens_per_slot
        npr = self.nodes_per_replica
        starts = [0] * (p.n_nodes + 1)
        for i, c in enumerate(counts_l):
            starts[i + 1] = starts[i] + c
        for replica in range(p.n_replicas):
            lo = replica * npr
            nodes = range(lo, lo + npr)
            queued = 0
            work = 0
            n_act = 0
            tokens = 0
            node_snaps = []
            for n in nodes:
                q_n = len(self.queues[n])
                queued += q_n
                work += self._queued_work[n]
                k = counts_l[n]
                tok_n = 0
                w_n = self._queued_work[n]
                if k:
                    n_act += k
                    tok_n = self._kv_base[n] + self._tok_off[n] * k
                    tokens += tok_n
                    w_n += int(w_all[starts[n]:starts[n + 1]].sum())
                node_snaps.append(NodeSnapshot(
                    node=n, queue_depth=q_n, active=k,
                    slots=p.slots_per_node,
                    kv_occupancy=(min(tok_n / node_cap, 1.0)
                                  if node_cap else 0.0),
                    expected_work=float(w_n),
                    dev_active=tuple(self._dev_count[n])))
            if n_act:
                work += int(w_all[starts[lo]:starts[lo + npr]].sum())
            occ = min(tokens / cap, 1.0) if cap else 0.0
            self._view_link.send(t, ReplicaSnapshot(
                replica=replica, ts=t, queue_depth=queued, active=n_act,
                slots=self.nodes_per_replica * p.slots_per_node,
                kv_occupancy=occ, expected_work=float(work),
                nodes=tuple(node_snaps)))
            occ_l.append(int(occ * 100))
        for snap in self._view_link.deliver(t):
            self.router.observe(snap)
        # router-visible KV telemetry, one row per replica
        self._emit_cols((t, p.n_replicas), EventKind.QUEUE_SAMPLE,
                        node=self._replica_lo, depth=np.asarray(occ_l,
                                                                np.int64),
                        meta=META_KV_OCC, replica=self._replica_ids)

    # ------------------------------------------------------------------
    # decode round: the heart of the sim (phase-major, columnar)
    # ------------------------------------------------------------------

    def _decode_round(self, t: float) -> None:
        p, f = self.p, self.fault
        act_t = f.active(t)
        # a degraded replica: every node in it decodes at 1/k cadence
        # (thermal throttling / a bad host in the DP group) — egress
        # thins out and its queue builds while peers stay healthy
        if (act_t and f.replica_slow >= 0
                and (self.round % max(int(f.replica_slow_mult), 1)) != 0):
            run_nodes = [nd for nd in range(p.n_nodes)
                         if self._replica_of(nd) != f.replica_slow]
        else:
            run_nodes = list(range(p.n_nodes))
        # a CPU-bottlenecked host can't admit/prefill either
        hs_node = (f.host_slow_node
                   if act_t and f.host_slow_node >= 0
                   and (self.round % 6) != 0 else -1)
        for node in run_nodes:
            if node != hs_node:
                self._refill_slots(node, t)
        self._flush_prefills()
        m = self.metrics
        for node in run_nodes:
            b = len(self.active[node])
            m.slot_rounds_busy += b
            if self.queues[node]:
                m.slot_rounds_idle += p.slots_per_node - b
        # background NIC load rides the wire regardless of decode state
        if act_t and f.nic_background_frac > 0:
            self._nic_background_phase(t, run_nodes)
        live = [nd for nd in run_nodes if self.active[nd]]
        if not live:
            return
        # a CPU-bottlenecked host orchestrates every decode step; when it
        # stalls, the node's whole loop runs at 1/6 cadence — DMA rate
        # sags, doorbells go sparse, and it straggles collectives
        normal = [nd for nd in live if nd != hs_node]
        stop_on = act_t and f.node_stop >= 0 and t >= f.node_stop_at

        # ---- H2D feed (decode inputs) per device ----
        self._h2d_phase(t, normal)

        # ---- dispatch (doorbell): only devices that hold work ----
        disp = self._dispatch_phase(t, normal)

        # ---- TP collective burst (east-west) ----
        coll_nodes, coll_disp = [], []
        for nd in live:
            if nd == hs_node:
                # still answers the TP collective, late (bunched dispatch)
                coll_nodes.append(nd)
                coll_disp.append(t + 6e-3)
            elif not (stop_on and f.node_stop == nd):
                coll_nodes.append(nd)
                coll_disp.append(disp[nd])
        self._collective_phase(t, coll_nodes, coll_disp)

        # ---- per-collective tier: explicit AG / RS ops (Table 3e) ----
        if p.per_collective:
            self._per_collective_phase(t, coll_nodes, coll_disp)

        # ---- rail / NVLink-domain tier (cross-domain legs share rails) ----
        if p.rail_domain_size > 0:
            self._rail_phase(t, coll_nodes)

        # ---- PP stage handoff (nodes pair up across stages) ----
        self._pp_phase(t, normal)

        # ---- intra-node P2P ----
        self._p2p_intra_phase(t, normal)

        # ---- D2H returns + egress ----
        eg_nodes = self._hbm_gate(t, normal) if p.hbm_knee > 0 else normal
        if eg_nodes:
            self._d2h_egress_phase(t, eg_nodes, stop_on)

        # ---- KV transfers ----
        self._kv_phase(t, normal)

    def _refill_slots(self, node: int, t: float) -> None:
        p = self.p
        act = self.active[node]
        q = self.queues[node]
        if not q or (not self._continuous and act):
            # static batching: only admit when the whole batch drained
            return
        added: list[Request] = []
        pfx = self._pfx is not None
        cap = min(p.slots_per_node, self._slot_cap)
        while len(act) < cap and q:
            if pfx and self._pfx_busy[node] > t:
                break   # the node's prefill unit is still chewing
            r = q.popleft()
            self._queued_work[node] -= max(r.decode_len, 1)
            self._prefill(r, t)
            act.append(r)
            added.append(r)
        if added:
            self._extend_mirrors(node, added)

    def _prefill(self, r: Request, t: float) -> None:
        p = self.p
        r.start_decode = t
        h2d_bytes = r.prompt_len * p.h2d_tok_bytes
        prefill_pen = 0.0
        if self._pfx is not None:
            prefill_pen, h2d_bytes = self._prefix_lookup(r, h2d_bytes)
            busy = self._pfx_busy[r.node]
            self._pfx_busy[r.node] = (busy if busy > t else t) + prefill_pen
        # first token leaves one decode step after admission (plus the
        # prefill compute the prefix cache did not cover)
        self.metrics.ttfts.append(
            t - r.arrival + p.egress_frac * p.decode_step + prefill_pen)
        # scheduler places the sequence on the least-loaded device slot
        counts = self._dev_count[r.node]
        r.device = counts.index(min(counts))
        counts[r.device] += 1
        self._pair_add(r.node, r.device)
        self._pref_ts.append(t + 1e-4)
        self._pref_nodes.append(r.node)
        self._pref_devs.append(r.device)
        self._pref_bytes.append(h2d_bytes)
        self._pref_flows.append(r.flow)

    def _prefix_lookup(self, r: Request, h2d_bytes: int) -> tuple[float, int]:
        """Bounded per-node LRU of session prefix keys.

        A hit skips ``prefix_frac`` of the prompt's prefill compute and of
        its H2D feed (the cached prefix never crosses the bus again); a
        miss pays the full prefill and evicts the oldest session.  This is
        what makes affinity routing *matter*: a policy that scatters a
        session across nodes thrashes every node's cache.
        """
        p = self.p
        key = r.session if r.session >= 0 else r.flow
        cache = self._pfx[r.node]
        full_pen = r.prompt_len * p.prefill_tok_s
        if key in cache:
            del cache[key]          # refresh LRU recency
            cache[key] = True
            self.metrics.prefix_hits += 1
            return (full_pen * (1.0 - p.prefix_frac),
                    max(int(h2d_bytes * (1.0 - p.prefix_frac)), 1))
        self.metrics.prefix_misses += 1
        cache[key] = True
        if len(cache) > p.prefix_cache_sessions:
            del cache[next(iter(cache))]
        return full_pen, h2d_bytes

    def _pair_add(self, node: int, dev: int) -> None:
        pair = (node, dev)
        i = bisect_left(self._pairs, pair)
        if i < len(self._pairs) and self._pairs[i] == pair:
            self._pair_sizes[i] += self.p.d2h_tok_bytes
        else:
            self._pairs.insert(i, pair)
            self._pair_sizes.insert(i, self.p.d2h_tok_bytes)
            self._pairs_dirty = True

    def _pair_remove(self, node: int, dev: int) -> None:
        pair = (node, dev)
        i = bisect_left(self._pairs, pair)
        if self._pair_sizes[i] > self.p.d2h_tok_bytes:
            self._pair_sizes[i] -= self.p.d2h_tok_bytes
        else:
            del self._pairs[i]
            del self._pair_sizes[i]
            self._pairs_dirty = True

    def _pair_arrays(self) -> tuple:
        if self._pairs_dirty:
            if self._pairs:
                arr = np.asarray(self._pairs, np.int64)
                self._pairs_node = np.ascontiguousarray(arr[:, 0])
                self._pairs_dev = np.ascontiguousarray(arr[:, 1])
                self._pairs_off = self._pairs_dev * 1e-6
            else:
                self._pairs_node = np.empty(0, np.int64)
                self._pairs_dev = np.empty(0, np.int64)
                self._pairs_off = np.empty(0, np.float64)
            self._pairs_dirty = False
        return self._pairs_node, self._pairs_dev, self._pairs_off

    def _fold_tokens(self, node: int) -> None:
        """Fold the lazy egress-round offset into the remaining counts."""
        off = self._tok_off[node]
        if off:
            mir = self._mir[node]
            mir[MIR_REM] -= off
            self._kv_base[node] += off * mir.shape[1]
            self._rem_min[node] -= off
            self._tok_off[node] = 0

    def _extend_mirrors(self, node: int, added: list[Request]) -> None:
        self._fold_tokens(node)
        rem_new = [r.decode_len - r.tokens_out for r in added]
        new = np.asarray([[r.flow for r in added],
                          [r.decode_len for r in added],
                          [r.prompt_len for r in added],
                          [r.device for r in added],
                          rem_new], np.int64)
        old = self._mir[node]
        self._mir[node] = (np.concatenate([old, new], axis=1)
                           if old.shape[1] else new)
        self._rem_min[node] = min(self._rem_min[node], min(rem_new))
        self._kv_base[node] += sum(r.prompt_len + r.tokens_out
                                   for r in added)
        self._mver += 1

    def _flush_prefills(self) -> None:
        if not self._pref_ts:
            return
        self._emit_h2d_cols(
            np.asarray(self._pref_ts, np.float64),
            np.asarray(self._pref_nodes, np.int64),
            np.asarray(self._pref_devs, np.int64),
            np.asarray(self._pref_bytes, np.int64),
            np.asarray(self._pref_flows, np.int64))
        self._pref_ts.clear()
        self._pref_nodes.clear()
        self._pref_devs.clear()
        self._pref_bytes.clear()
        self._pref_flows.clear()

    def _emit_h2d_cols(self, ts: np.ndarray, node: np.ndarray,
                       dev: np.ndarray, nbytes: np.ndarray,
                       flow: np.ndarray | None) -> None:
        """All H2D side effects, columnar: split DMAs, device skew,
        registration churn, PCIe background load."""
        p, f = self.p, self.fault
        n = ts.shape[0]
        if n == 0:
            return
        if not self._h2d_knobs or f.mitigated:
            # healthy fast path: no fault shaping, sizes already >= 1
            self._emit_cols(ts, EventKind.H2D_XFER, node=node, device=dev,
                            flow=-1 if flow is None else flow, size=nbytes)
            return
        if flow is None:
            flow = np.full(n, -1, np.int64)
        act = (ts >= f.start) if not f.mitigated else np.zeros(n, bool)
        any_act = bool(act.any())
        if any_act and f.skew_device is not None:
            sn, sd = f.skew_device
            m = act & (node == sn) & (dev == sd)
            if m.any():
                nbytes = np.where(
                    m, (nbytes * f.skew_factor).astype(np.int64), nbytes)
        if any_act and f.h2d_split > 1:
            # short-lived tiny DMAs: expand each transfer into its splits
            split = np.where(act, np.int64(f.h2d_split), np.int64(1))
            per = np.maximum(1, nbytes // split)
            rep = np.repeat(np.arange(n), split)
            ends = np.cumsum(split)
            j = np.arange(int(ends[-1])) - np.repeat(ends - split, split)
            ts_e = ts[rep] + j * 1e-5
            node_e, dev_e = node[rep], dev[rep]
            flow_e, per_e, act_e = flow[rep], per[rep], act[rep]
        else:
            per = np.maximum(1, nbytes)
            ts_e, node_e, dev_e = ts, node, dev
            flow_e, per_e, act_e = flow, per, act
        self._emit_cols(ts_e, EventKind.H2D_XFER, node=node_e, device=dev_e,
                        flow=flow_e, size=per_e)
        if any_act and f.reg_churn:
            # short-lived buffers: map before + unmap after every DMA
            tsm, nm = ts_e[act_e], node_e[act_e]
            dm, pm = dev_e[act_e], per_e[act_e]
            self._emit_cols(tsm - 2e-6, EventKind.MEM_REG, node=nm,
                            device=dm, size=pm)
            self._emit_cols(tsm + 2e-6, EventKind.MEM_REG, node=nm,
                            device=dm, size=pm)
        # PCIe background load (saturation fault)
        if any_act and f.pcie_background_frac > 0:
            per_round = int(f.pcie_background_frac * 64e9 * p.decode_step)
            self._emit_cols(ts[act] + 2e-4, EventKind.H2D_XFER,
                            node=node[act], device=dev[act], size=per_round)

    def _h2d_grid(self, nodes: tuple[int, ...]) -> tuple:
        """Cached (node, device) grid columns for a node set — the grids
        repeat every round, so the arrays are built once and shared
        (add_columns adopts them read-only)."""
        tmpl = self._tmpl_h2d.get(nodes)
        if tmpl is None:
            D = self.p.devices_per_node
            tmpl = (np.repeat(np.asarray(nodes, np.int64), D),
                    np.tile(np.arange(D, dtype=np.int64), len(nodes)))
            self._tmpl_h2d[nodes] = tmpl
        return tmpl

    def _h2d_phase(self, t: float, normal: list[int]) -> None:
        p, f = self.p, self.fault
        act_t = f.active(t)
        nodes = [nd for nd in normal
                 if not (act_t and f.h2d_stall_node == nd
                         and (self.round % int(f.h2d_stall_mult)) != 0)]
        if not nodes:
            return   # feed goes quiet for most rounds -> open gap grows
        k = len(nodes)
        D = p.devices_per_node
        node_a, dev_a = self._h2d_grid(tuple(nodes))
        per_node = [len(self.active[nd]) * p.h2d_tok_bytes // D + 1
                    for nd in nodes]
        nbytes = np.repeat(np.asarray(per_node, np.int64), D)
        ts = t + self.rng.random(k * D) * 1e-4
        self._emit_h2d_cols(ts, node_a, dev_a, nbytes, None)

    def _dispatch_phase(self, t: float, normal: list[int]) -> dict:
        p, f = self.p, self.fault
        if not normal:
            return {}
        delay = 2e-4
        jit_l = None
        if f.active(t):
            delay += f.dispatch_delay
            if f.dispatch_jitter_mult > 1.0:
                jit_l = self.rng.exponential(
                    f.dispatch_jitter_mult * 2e-4, len(normal)).tolist()
        if len(normal) == p.n_nodes:
            # all nodes live and running: the doorbell columns are exactly
            # the incrementally-maintained (node, device) pair arrays
            node_a, dev_a, off_a = self._pair_arrays()
            per_node = None
        else:
            key = (self._mver, tuple(normal))
            tmpl = self._disp_tmpl if key == self._disp_key else None
            if tmpl is None:
                D = p.devices_per_node
                node_l: list[int] = []
                dev_l: list[int] = []
                per_node = []
                for nd in normal:
                    cnt = self._dev_count[nd]
                    k = 0
                    for dv in range(D):
                        if cnt[dv]:
                            node_l.append(nd)
                            dev_l.append(dv)
                            k += 1
                    per_node.append(k)
                tmpl = (np.asarray(node_l, np.int64),
                        np.asarray(dev_l, np.int64),
                        np.asarray(dev_l, np.float64) * 1e-6,
                        per_node)
                self._disp_key = key
                self._disp_tmpl = tmpl
            node_a, dev_a, off_a, per_node = tmpl
        if jit_l is None:
            base = t + delay
            disp = dict.fromkeys(normal, base)
            ts = base + off_a
        else:
            bases = [t + delay + j for j in jit_l]
            disp = dict(zip(normal, bases))
            if per_node is None:
                per_node = [0] * p.n_nodes
                for nd, _ in self._pairs:
                    per_node[nd] += 1
            ts = np.repeat(np.asarray(bases), per_node) + off_a
        if ts.shape[0]:
            self._emit_cols(ts, EventKind.DISPATCH, node=node_a,
                            device=dev_a)
        return disp

    def _collective_phase(self, t: float, nodes: list[int],
                          disp_ts: list[float]) -> None:
        p, f = self.p, self.fault
        k = len(nodes)
        if k == 0:
            return
        node_a = np.asarray(nodes, np.int64)
        # realistic per-node arrival jitter (no exact ties)
        arrive = (np.asarray(disp_ts)
                  + (p.compute_frac * p.decode_step
                     + self.rng.random(k) * 4e-5))
        nbytes = p.collective_bytes
        if f.active(t):
            if f.straggler_node >= 0:
                arrive[node_a == f.straggler_node] += f.straggler_delay
            if f.collective_bytes_node >= 0:
                nbytes = np.where(
                    node_a == f.collective_bytes_node,
                    np.int64(int(p.collective_bytes
                                 * f.collective_bytes_mult)),
                    np.int64(p.collective_bytes))
            if f.fabric_jitter > 0:
                arrive += np.abs(self.rng.normal(0.0, f.fabric_jitter, k))
            if f.ew_retx_p > 0:
                m = self.rng.random(k) < f.ew_retx_p
                if m.any():
                    self._emit_cols(arrive[m] + 3e-4, EventKind.RETRANSMIT,
                                    node=node_a[m], size=p.mtu,
                                    meta=META_DIR_EW)
        self._emit_cols(arrive, EventKind.COLLECTIVE_BURST, node=node_a,
                        size=nbytes, op=int(CollectiveOp.ALL_REDUCE),
                        group=0, meta=self.round)

    def _per_collective_phase(self, t: float, nodes: list[int],
                              disp_ts: list[float]) -> None:
        """Per-collective emission tier (Table 3e).

        The aggregate TP burst (group 0) stays untouched; on top of it the
        round runs explicit all-gather (every round) and reduce-scatter
        (every 2nd round) ops, each rendered as a per-node *start* edge
        carrying the op's wire bytes plus a zero-byte *finish* edge whose
        timestamp is the node's actual completion.  Per-op start/finish
        skew is thereby a first-class DPU observable: one node's finishes
        drifting late against the group median is the
        ``collective_straggler`` signature.  All jitter draws come from
        the tier's dedicated stream (``rng_coll``) so the legacy RNG
        sequence — and the canonical golden fixtures — never move.
        """
        p, f = self.p, self.fault
        k = len(nodes)
        if k == 0:
            return
        node_a = np.asarray(nodes, np.int64)
        rid = self.round
        lag_on = (f.active(t) and f.collective_lag_node >= 0
                  and f.collective_lag > 0)
        ops = [(COLL_GROUP_ALL_GATHER, int(CollectiveOp.ALL_GATHER),
                p.coll_ag_bytes, 0.50)]
        if rid % 2 == 0:
            ops.append((COLL_GROUP_REDUCE_SCATTER,
                        int(CollectiveOp.REDUCE_SCATTER),
                        p.coll_rs_bytes, 0.62))
        disp_a = np.asarray(disp_ts, np.float64)
        for group, op, nbytes, frac in ops:
            start = (disp_a + frac * p.decode_step
                     + self.rng_coll.random(k) * 2e-5)
            fin = start + 1.2e-4 + self.rng_coll.random(k) * 4e-5
            if lag_on:
                fin = fin + np.where(node_a == f.collective_lag_node,
                                     f.collective_lag, 0.0)
            self._emit_cols(start, EventKind.COLLECTIVE_BURST, node=node_a,
                            size=nbytes, depth=COLL_EDGE_START, op=op,
                            group=group, meta=rid)
            self._emit_cols(fin, EventKind.COLLECTIVE_BURST, node=node_a,
                            size=0, depth=COLL_EDGE_FINISH, op=op,
                            group=group, meta=rid)

    def _rail_phase(self, t: float, nodes: list[int]) -> None:
        """Rail / NVLink-domain topology tier (DWDP-style, Table 3e).

        Nodes inside one domain (``node // rail_domain_size``) exchange
        over a fast intra-domain tier; each node's cross-domain leg rides
        its home rail (``node % rail_count``).  A rail is a *shared*
        resource: cutting its bandwidth slows every cross-domain leg on
        it, so the DPU sees one rail's finish timestamps drifting late
        versus its peers — congestion with no per-node signature, the
        ``rail_congestion`` fault axis.  The ``reroute_rail`` actuation
        round-robins legs over all rails (hot-rail bypass).
        """
        p, f = self.p, self.fault
        k = len(nodes)
        if k == 0:
            return
        node_a = np.asarray(nodes, np.int64)
        rid = self.round
        base = t + 0.55 * p.decode_step
        # intra-domain tier: near-instant, one finish row per node
        dom_a = node_a // p.rail_domain_size
        ts_dom = base + 2e-5 + self.rng_coll.random(k) * 1e-5
        self._emit_cols(ts_dom, EventKind.COLLECTIVE_BURST, node=node_a,
                        size=p.p2p_intra_bytes, depth=COLL_EDGE_FINISH,
                        op=int(CollectiveOp.ALL_REDUCE),
                        group=DOMAIN_GROUP_BASE + dom_a, meta=rid)
        # cross-domain legs over the (shared) rails
        nrail = max(p.rail_count, 1)
        if self._rail_reroute:
            rail_a = (node_a + rid) % nrail
        else:
            rail_a = node_a % nrail
        leg = 2e-4 + self.rng_coll.random(k) * 2e-5
        if f.active(t) and f.rail_cut >= 0 and f.rail_cut_mult > 1.0:
            leg = np.where(rail_a == f.rail_cut,
                           leg * f.rail_cut_mult, leg)
        self._emit_cols(base + leg, EventKind.COLLECTIVE_BURST,
                        node=node_a, size=p.collective_bytes // 4,
                        depth=COLL_EDGE_FINISH,
                        op=int(CollectiveOp.ALL_TO_ALL),
                        group=RAIL_GROUP_BASE + rail_a, meta=rid)

    def _hbm_gate(self, t: float, normal: list[int]) -> list[int]:
        """Memory-bandwidth saturation knee (Table 3e).

        Past the batch-size knee the per-token weight/KV streaming no
        longer hides behind compute, so a node's decode rounds stop
        fitting in the step: it completes (and egresses) only a
        ``knee / batch`` duty cycle of rounds, via a deterministic credit
        accumulator.  Token rate saturates at ``knee / decode_step``
        while the request queues stay flat — the latency cliff with no
        queueing signature that ``hbm_bandwidth_cliff`` keys on.
        """
        p, f = self.p, self.fault
        knee = p.hbm_knee
        if f.active(t) and f.hbm_knee_shift > 0:
            knee = f.hbm_knee_shift
        out = []
        credit = self._hbm_credit
        for nd in normal:
            b = len(self.active[nd])
            if b <= knee:
                out.append(nd)
                continue
            c = credit[nd] + knee / b
            if c >= 1.0:
                credit[nd] = c - 1.0
                out.append(nd)
            else:
                credit[nd] = c
        return out

    def _pp_phase(self, t: float, normal: list[int]) -> None:
        p, f = self.p, self.fault
        half = p.n_nodes // 2
        if half == 0:
            return
        nodes = [nd for nd in normal if nd < half]
        if not nodes:
            return
        k = len(nodes)
        node_a = np.asarray(nodes, np.int64)
        group_a = None
        if f.active(t) and f.stage_gap_growth > 0:
            inc = f.stage_gap_growth / max(half, 1)
            gaps = self._pp_extra_gap + inc * np.arange(1, k + 1)
            self._pp_extra_gap = float(gaps[-1])
            ts = t + 0.6 * p.decode_step + gaps
            limit = t + 5 * p.decode_step
            over = ts > limit
            if over.any():
                # stalled stage: usually emit nothing this round (bubble
                # widens); survivors clamp near the round
                u = self.rng.random(int(over.sum()))
                drop = np.zeros(k, bool)
                drop[over] = u < 0.8
                keep = ~drop
                ts = np.where(over, limit, ts)[keep]
                node_a = node_a[keep]
                group_a = 100 + node_a
        else:
            key = tuple(nodes)
            tmpl = self._tmpl_pp.get(key)
            if tmpl is None:
                tmpl = (node_a, 100 + node_a)
                self._tmpl_pp[key] = tmpl
            node_a, group_a = tmpl
            self._emit_cols((t + 0.6 * p.decode_step, k),
                            EventKind.P2P_BURST, node=node_a,
                            size=p.collective_bytes // 2, group=group_a,
                            meta=META_P2P_INTER)
            return
        if ts.shape[0]:
            self._emit_cols(ts, EventKind.P2P_BURST, node=node_a,
                            size=p.collective_bytes // 2,
                            group=100 + node_a if group_a is None
                            else group_a,
                            meta=META_P2P_INTER)

    def _hol_stalled(self, node: int, t: float) -> bool:
        """HoL fault: a subset of nodes' streams freeze in 0.3 s windows."""
        f = self.fault
        if not (f.active(t) and f.hol_stall_frac > 0):
            return False
        n_stalled = max(1, int(f.hol_stall_frac * self.p.n_nodes))
        return node < n_stalled and (int(t / 0.3) % 2) == 1

    def _p2p_intra_phase(self, t: float, normal: list[int]) -> None:
        p, f = self.p, self.fault
        # same size, but a slow node's bursts come at 1/3 cadence -> the
        # size/dt throughput proxy drops 3x
        slow_skip = (f.active(t) and f.p2p_slow_node >= 0
                     and (self.round % 3) != 0)
        nodes = [nd for nd in normal
                 if not (slow_skip and nd == f.p2p_slow_node)
                 and not self._hol_stalled(nd, t)]
        if not nodes:
            return
        key = tuple(nodes)
        tmpl = self._tmpl_p2p.get(key)
        if tmpl is None:
            node_a = np.asarray(nodes, np.int64)
            tmpl = (node_a, 10 + node_a)
            self._tmpl_p2p[key] = tmpl
        node_a, flow_a = tmpl
        self._emit_cols((t + 0.4 * p.decode_step, len(nodes)),
                        EventKind.P2P_BURST, node=node_a,
                        device=self.round % p.devices_per_node,
                        flow=flow_a, size=p.p2p_intra_bytes,
                        meta=META_P2P_INTRA)

    def _egress_tmpl(self, normal: list[int]) -> dict:
        """Fused cross-node egress column template, rebuilt only when
        active-set membership or the running-node set changes."""
        key = (self._mver, tuple(normal))
        if key == self._eg_key:
            return self._eg_tmpl
        counts = [self._mir[nd].shape[1] for nd in normal]
        starts = [0] * (len(normal) + 1)
        for i, c in enumerate(counts):
            starts[i + 1] = starts[i] + c
        node_col = np.repeat(np.asarray(normal, np.int64), counts)
        tmpl = {
            "counts": np.asarray(counts, np.int64),
            "counts_l": counts,
            "starts": starts,
            "total": starts[-1],
            "flow": np.concatenate([self._mir[nd][MIR_FLOW]
                                    for nd in normal]),
            "node": node_col,
            "replica": node_col // self.nodes_per_replica,
            "within": np.concatenate([self._ar_eg[:c] for c in counts]),
        }
        self._eg_key = key
        self._eg_tmpl = tmpl
        return tmpl

    def _d2h_egress_phase(self, t: float, normal: list[int],
                          stop_on: bool) -> None:
        p, f = self.p, self.fault
        act_t = f.active(t)
        base = t + p.egress_frac * p.decode_step
        d2h_delay = ((f.d2h_delay_mult - 1.0) * 5e-4
                     if act_t and f.d2h_delay_mult > 1.0 else 0.0)
        jit = act_t and f.egress_jitter_mult > 1.0
        retx = act_t and f.egress_retx_p > 0
        m = self.metrics
        tmpl = self._egress_tmpl(normal)
        total = tmpl["total"]
        # one aggregated D2H (logits/sampled ids) per device per step, the
        # way a real outfeed looks on the bus
        stop_nd = f.node_stop if stop_on else -1
        if stop_nd == -1 and len(normal) == self.p.n_nodes:
            node_a, dev_a, off_a = self._pair_arrays()
            if node_a.shape[0]:
                self._emit_cols((base + d2h_delay) + off_a,
                                EventKind.D2H_XFER, node=node_a,
                                device=dev_a,
                                size=np.asarray(self._pair_sizes, np.int64))
        else:
            d2h_node: list[int] = []
            d2h_dev: list[int] = []
            d2h_size: list[int] = []
            d2h_off: list[float] = []
            normal_s = set(normal)
            for i, (nd, dv) in enumerate(self._pairs):
                if nd != stop_nd and nd in normal_s:
                    d2h_node.append(nd)
                    d2h_dev.append(dv)
                    d2h_size.append(self._pair_sizes[i])
                    d2h_off.append(dv * 1e-6)
            if d2h_node:
                self._emit_cols((base + d2h_delay)
                                + np.asarray(d2h_off, np.float64),
                                EventKind.D2H_XFER,
                                node=np.asarray(d2h_node, np.int64),
                                device=np.asarray(d2h_dev, np.int64),
                                size=np.asarray(d2h_size, np.int64))
        if not total:
            return
        backlog = self._egress_backlog
        eb = [base + 2e-4 + (b if b < 40.0 else 40.0) * 1e-4
              for b in (backlog[nd] for nd in normal)]
        ts = np.repeat(np.asarray(eb), tmpl["counts"]) + tmpl["within"]
        if jit:
            # cap jitter so event time stays near the round (the plane's
            # clock follows event timestamps)
            ts = ts + np.minimum(self.rng.exponential(
                f.egress_jitter_mult * 2e-4, total), 10e-3)
        m.tokens_out += total
        tok_off = self._tok_off
        fin_nodes = None
        for i, nd in enumerate(normal):
            if tmpl["counts_l"][i]:
                off = tok_off[nd] + 1
                tok_off[nd] = off
                if off >= self._rem_min[nd]:
                    if fin_nodes is None:
                        fin_nodes = []
                    fin_nodes.append(i)
        flows = tmpl["flow"]
        if retx:
            um = self.rng.random(total) < f.egress_retx_p
            if um.any():
                self._emit_cols(ts[um] + 4e-4, EventKind.RETRANSMIT,
                                node=tmpl["node"][um], flow=flows[um],
                                size=p.mtu, meta=META_DIR_EGRESS)
        meta = 0
        if fin_nodes is not None:
            meta = np.zeros(total, np.int64)
            starts = tmpl["starts"]
            for i in fin_nodes:
                nd = normal[i]
                s, e = starts[i], starts[i + 1]
                fin = self._mir[nd][MIR_REM] <= tok_off[nd]
                meta[s:e] = np.where(fin, int(META_FIN), 0)
                self._complete(nd, fin, ts[s:e])
        self._emit_cols(ts, EventKind.EGRESS_PKT, node=tmpl["node"],
                        flow=flows, size=p.egress_tok_bytes,
                        group=tmpl["node"], meta=meta,
                        replica=tmpl["replica"])

    def _complete(self, nd: int, fin: np.ndarray, ts: np.ndarray) -> None:
        """Retire finished sequences: metrics, object sync, mirror filter."""
        m = self.metrics
        act = self.active[nd]
        cnt = self._dev_count[nd]
        mir = self._mir[nd]
        dev = mir[MIR_DEV]
        dec = mir[MIR_DEC]
        fin_l = fin.tolist()
        for i in np.flatnonzero(fin).tolist():
            r = act[i]
            r.finish = float(ts[i])
            r.tokens_out = int(dec[i])   # finished exactly at decode_len
            m.completed += 1
            m.latencies.append(r.finish - r.arrival)
            cnt[dev[i]] -= 1
            self._pair_remove(nd, int(dev[i]))
        self.active[nd] = [r for i, r in enumerate(act) if not fin_l[i]]
        self._fold_tokens(nd)
        mir = self._mir[nd][:, ~fin]
        self._mir[nd] = mir
        if mir.shape[1]:
            rem = mir[MIR_REM]
            self._rem_min[nd] = int(rem.min())
            self._kv_base[nd] = int((mir[MIR_PROMPT] + mir[MIR_DEC]
                                     - rem).sum())
        else:
            self._rem_min[nd] = 1 << 60
            self._kv_base[nd] = 0
        self._mver += 1

    def _kv_phase(self, t: float, normal: list[int]) -> None:
        p, f = self.p, self.fault
        nodes = [nd for nd in normal if not self._hol_stalled(nd, t)]
        if not nodes:
            return
        # healthy background: steady small page migrations, stable stream id
        if self.round % 16 == 0:
            healthy = [nd for nd in nodes if self.active[nd]]
            if healthy:
                node_a, flow_a, _ = self._kv_tmpl(tuple(healthy))
                self._emit_cols(
                    (t + 0.5 * p.decode_step, len(healthy)),
                    EventKind.P2P_BURST, node=node_a, flow=flow_a,
                    size=p.kv_page_bytes, meta=META_P2P_KV)
        if f.active(t) and f.kv_heavy:
            # one flow per node repeatedly migrates big KV slabs, hogging
            # the link while the regular page streams starve
            node_a, _, heavy_a = self._kv_tmpl(tuple(nodes))
            self._emit_cols((t + 0.55 * p.decode_step, len(nodes)),
                            EventKind.P2P_BURST, node=node_a,
                            flow=heavy_a,
                            size=192 * p.kv_page_bytes, meta=META_P2P_KV)

    def _kv_tmpl(self, key: tuple) -> tuple:
        tmpl = self._tmpl_kv.get(key)
        if tmpl is None:
            node_a = np.asarray(key, np.int64)
            tmpl = (node_a, 50 + node_a, node_a * 1000)
            self._tmpl_kv[key] = tmpl
        return tmpl

    def _nic_background_phase(self, t: float, run_nodes: list[int]) -> None:
        p, f = self.p, self.fault
        cap = 200e9 / 8  # matches DetectorConfig.nic_Bps
        per_round = f.nic_background_frac * cap * p.decode_step
        k = len(run_nodes)
        key = tuple(run_nodes)
        if key != self._nic_key:
            self._nic_tmpl = (np.tile(np.arange(8, dtype=np.float64), k),
                              np.repeat(np.asarray(run_nodes, np.int64), 8))
            self._nic_key = key
        j, node_a = self._nic_tmpl
        ts = t + (j + self.rng.random(8 * k)) * (p.decode_step / 8)
        self._emit_cols(ts, EventKind.INGRESS_PKT, node=node_a,
                        flow=-1, size=int(per_round / 8))

    def _credits(self, t: float) -> None:
        p, f = self.p, self.fault
        if t < self._next_credit:
            return
        self._next_credit = t + p.credit_every
        n = p.n_nodes
        if f.active(t) and f.credit_starve:
            # credits trickle in rarely and empty
            starved = self.rng.random(n) < 0.1
            if starved.any():
                nodes = np.flatnonzero(starved).astype(np.int64)
                self._emit_cols((t, nodes.shape[0]),
                                EventKind.CREDIT_UPDATE, node=nodes, depth=0)
        else:
            self._emit_cols((t, n), EventKind.CREDIT_UPDATE,
                            node=self._all_nodes, depth=32)

    def _flood_phase(self, t: float) -> None:
        """Debug-tap event storm: a misconfigured verbose tap exports k
        extra rows per round.  The rows carry no pathological signal of
        their own (``META_TAP_DEBUG``; no detector keys on it) — their only
        effect is consuming DPU ingest budget, which is exactly the
        ``dpu_saturation`` experiment."""
        f = self.fault
        if not f.active(t):
            return
        k = int(f.telemetry_flood)
        tmpl = self._flood_tmpl
        if tmpl is None or tmpl[0] != k:
            self._flood_tmpl = tmpl = (
                k, np.arange(k, dtype=np.float64),
                np.arange(k, dtype=np.int64) % self.p.n_nodes)
        _, j, nodes = tmpl
        ts = t + (j + self.rng.random(k)) * (self.p.decode_step / k)
        self._emit_cols(ts, EventKind.QUEUE_SAMPLE, node=nodes,
                        meta=META_TAP_DEBUG)


def _merge_chaos(dpu: DPUParams | None, fault: FaultSpec) -> DPUParams | None:
    """Fold the fault's monitoring-plane chaos knobs into the sidecar params.

    Returns ``dpu`` unchanged (possibly None) when no chaos knob is set, so
    every pre-existing scenario constructs the exact same sidecar as before
    — the partition windows live in :class:`LinkParams` and are pure clock
    comparisons, so the merged configs also draw zero extra randomness.
    """
    import dataclasses
    f = fault
    uplink_chaos = (f.uplink_blackout_start >= 0.0 or f.uplink_corrupt_p > 0.0
                    or f.uplink_duplicate_p > 0.0)
    if not (uplink_chaos or f.dpu_crash_at >= 0.0
            or f.downlink_partition_start >= 0.0):
        return dpu
    dp = dpu or DPUParams()
    if uplink_chaos:
        up = dp.uplink
        if f.uplink_blackout_start >= 0.0:
            up = dataclasses.replace(up,
                                     partition_start=f.uplink_blackout_start,
                                     partition_duration=f.uplink_blackout_s)
        if f.uplink_corrupt_p > 0.0:
            up = dataclasses.replace(up, corrupt_p=f.uplink_corrupt_p)
        if f.uplink_duplicate_p > 0.0:
            up = dataclasses.replace(up, duplicate_p=f.uplink_duplicate_p)
        dp = dataclasses.replace(dp, uplink=up)
    if f.downlink_partition_start >= 0.0:
        down = dataclasses.replace(dp.downlink,
                                   partition_start=f.downlink_partition_start,
                                   partition_duration=f.downlink_partition_s)
        dp = dataclasses.replace(dp, downlink=down)
    if f.dpu_crash_at >= 0.0:
        dp = dataclasses.replace(dp, crash_at=f.dpu_crash_at,
                                 restart_after=f.dpu_restart_after)
    return dp


def _merge_standby_chaos(standby: DPUParams, fault: FaultSpec) -> DPUParams:
    """Fold the standby-specific chaos knobs into the standby's params.

    Same contract as :func:`_merge_chaos`: unchanged object when no knob is
    set, pure clock windows when they are.
    """
    import dataclasses
    f = fault
    sp = standby
    if f.standby_blackout_start >= 0.0:
        up = dataclasses.replace(sp.uplink,
                                 partition_start=f.standby_blackout_start,
                                 partition_duration=f.standby_blackout_s)
        sp = dataclasses.replace(sp, uplink=up)
    if f.standby_crash_at >= 0.0:
        sp = dataclasses.replace(sp, crash_at=f.standby_crash_at,
                                 restart_after=f.standby_restart_after)
    return sp


def _merge_watchdog_chaos(wd: "WatchdogParams", fault: FaultSpec
                          ) -> "WatchdogParams":
    """Fold the OOB-port partition window into the watchdog params."""
    import dataclasses
    if fault.oob_partition_start < 0.0:
        return wd
    return dataclasses.replace(wd,
                               oob_partition_start=fault.oob_partition_start,
                               oob_partition_s=fault.oob_partition_s)


def run_scenario(fault: FaultSpec,
                 params: SimParams | None = None,
                 workload: WorkloadSpec | None = None,
                 mitigate: bool = False,
                 tables: tuple[str, ...] = DEFAULT_TABLES,
                 control: str | None = None,
                 ) -> tuple[SimMetrics, TelemetryPlane, ClusterSim]:
    """Run one fault scenario with the full telemetry plane attached.

    ``control`` picks the loop topology (defaults to ``params.control``):

      "none"    — detectors watch, nobody acts (the measurement baseline);
      "instant" — the legacy zero-latency in-process controller;
      "dpu"     — the default closed-loop path: a :class:`DPUSidecar` with
                  modeled transport, on-DPU budget, policy arbitration, and
                  a command bus back to the sim's actuators.  Detection
                  still runs (budget-paced) when ``mitigate`` is False.

    The returned plane is always the inner :class:`TelemetryPlane`
    (findings / attributions / actions), whichever topology produced it; in
    dpu mode the sidecar itself is reachable as ``sim.plane``.  With
    ``params.watchdog`` set the returned plane is the :class:`Watchdog`
    (same findings/attributions/actions surface, merged with the standby's).
    """
    import dataclasses
    params = params or SimParams()
    workload = workload or WorkloadSpec()
    # arrivals must span the whole sim: a workload that simply *ends* is
    # indistinguishable from ingress starvation at the DPU vantage point
    workload = dataclasses.replace(workload, duration=params.duration * 0.98)
    mode = control if control is not None else params.control
    if mode == "auto":
        mode = "dpu" if mitigate else "none"
    if mode == "dpu":
        plane = TelemetryPlane(n_nodes=params.n_nodes, mitigate=False,
                               tables=tables)
        dp = _merge_chaos(params.dpu, fault)
        side = DPUSidecar(plane, dp, seed=params.seed,
                          mitigate=mitigate)
        ctrl = side
        if params.watchdog is not None:
            standby = None
            if params.standby is not None:
                # the hot standby shadows the same tap over its own
                # modeled uplink; a distinct derived seed keeps its link
                # schedule independent of the primary's without touching
                # the primary's draw sequence
                sb_plane = TelemetryPlane(n_nodes=params.n_nodes,
                                          mitigate=False, tables=tables)
                sbp = _merge_standby_chaos(params.standby, fault)
                standby = DPUSidecar(sb_plane, sbp,
                                     seed=params.seed ^ 0x5B17,
                                     mitigate=mitigate)
            wd = _merge_watchdog_chaos(params.watchdog, fault)
            ctrl = Watchdog(side, wd, tables=tables,
                            mitigate=mitigate, standby=standby)
        sim = ClusterSim(params, workload, fault, ctrl)
        ctrl.bind(sim)
        if params.trace:
            tracer, recorder = _build_tracer(fault)
            if params.watchdog is not None:
                ctrl.attach_tracer(tracer, recorder=recorder)
            else:
                side.attach_tracer(tracer, "primary", recorder=recorder)
            sim.tracer = tracer
            sim.recorder = recorder
        metrics = sim.run()
        return metrics, (ctrl if params.watchdog is not None else plane), sim
    if mode not in ("none", "instant"):
        raise ValueError(f"unknown control mode {mode!r}")
    plane = TelemetryPlane(n_nodes=params.n_nodes,
                           mitigate=mitigate and mode == "instant",
                           tables=tables)
    sim = ClusterSim(params, workload, fault, plane)
    if mitigate and plane.controller is not None:
        plane.controller.engine = sim
    if params.trace:
        tracer, recorder = _build_tracer(fault)
        plane.tracer = tracer
        plane.trace_source = "plane"
        plane.recorder = recorder
        sim.tracer = tracer
        sim.recorder = recorder
    metrics = sim.run()
    return metrics, plane, sim


def _build_tracer(fault: FaultSpec):
    """One shared Tracer + FlightRecorder per traced run (lazy import:
    the obs layer must never be on the untraced hot path)."""
    from repro_torch.obs import FlightRecorder, Tracer
    recorder = FlightRecorder()
    tracer = Tracer(
        fault_start=fault.start if fault.row_id else None,
        fault_row=fault.row_id or None,
        recorder=recorder)
    return tracer, recorder
