"""Declarative runbook registry — the paper's Tables 3(a)/(b)/(c) as data.

Each ``RunbookEntry`` carries the paper's row verbatim (signal, lifecycle
stages, effect on node<->node traffic, likely root cause, mitigation
directives) plus the executable detector class bound to it and the mitigation
*action* key the controller understands.

The registry is the single source of truth: detectors, the attribution
engine, the mitigation controller, the simulator's fault injectors, tests,
and the per-table benchmarks all iterate over it, so a row cannot silently
lose coverage.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import detectors as D
from repro_torch.core.detectors import Detector, DetectorConfig


@dataclass(frozen=True)
class RunbookEntry:
    row_id: str                 # stable id == Detector.name
    table: str                  # "3a" | "3b" | "3c" | "3d" | "3e"
    title: str                  # paper's "Skew/Imbalance" column
    signal: str                 # paper's "Signal (Red Flag)" column
    stages: str                 # paper's "Lifecycle Stages Affected"
    effect: str                 # paper's "Effect on Node<->Node Traffic"
    root_cause: str             # paper's "Likely Root Cause"
    mitigation: str             # paper's "Mitigation Directives"
    detector_cls: type[Detector]
    action: str                 # mitigation-controller action key
    scenario: str               # sim fault-injection scenario name
    #: rows that observe the same underlying pathology from another vantage
    #: (e.g. decode early-stop seen PCIe-side vs egress-side).  A recovery
    #: attributed to a sibling row counts as this row's recovery in the
    #: control-loop gates — see ``row_hit``.
    sibling_rows: tuple[str, ...] = ()


RUNBOOK_3A: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "burst_admission_backlog", "3a", "Burst admission backlog",
        "Sudden spikes of ingress requests followed by queueing delay",
        "Ingress (prefill/start)",
        "Downstream GPU sees uneven load; internode bursts clump",
        "Load spike from clients, front-end batching, NIC queue limits",
        "Smooth input batching, rate-limit clients, increase NIC queue depth",
        D.BurstAdmissionBacklog, action="smooth_admission",
        scenario="burst_admission"),
    RunbookEntry(
        "ingress_starvation", "3a", "Ingress starvation / thin traffic",
        "Long gaps between ingress packets for some tokens",
        "Ingress -> PCIe feed",
        "Token stalls; fewer collective ops downstream",
        "Upstream service jitter, uneven client distribution",
        "Balance load-balancer hashing, check NIC RSS/flow steering",
        D.IngressStarvation, action="rebalance_frontend",
        scenario="ingress_starvation"),
    RunbookEntry(
        "flow_skew_across_sessions", "3a", "Flow skew across sessions",
        "Some ingress flows high-volume, others sparse",
        "Ingress (per-request)",
        "Imbalanced TP/PP participation across tokens",
        "Session affinity mismatch, QUIC stream imbalance",
        "Verify flow hashing, rebalance RPC streams",
        D.FlowSkewAcrossSessions, action="rebalance_frontend",
        scenario="flow_skew"),
    RunbookEntry(
        "ingress_drop_retransmit", "3a", "Ingress drop/retransmit",
        "Missing or retransmitted initial packets (handshake retries)",
        "Ingress (request birth)",
        "Token ID not consistently assigned; lifecycle gaps",
        "Congestion, MTU mismatch, link errors",
        "Enable NIC offloads (TSO/GRO), verify MTU, check cabling",
        D.IngressDropRetransmit, action="tune_transport",
        scenario="ingress_retransmit"),
    RunbookEntry(
        "egress_backlog_queueing", "3a", "Egress backlog / queueing",
        "Responses accumulate in NIC queues before send",
        "Egress (response flush)",
        "Downstream clients see latency spikes",
        "CPU copy bottleneck, NIC buffer exhaustion",
        "Offload checksums, zero-copy send, increase NIC buffer size",
        D.EgressBacklogQueueing, action="enlarge_egress_buffers",
        scenario="egress_backlog"),
    RunbookEntry(
        "egress_jitter", "3a", "Egress jitter",
        "Outgoing packets for a token spread unevenly over time",
        "Egress (decode outputs)",
        "Clients see irregular token cadence",
        "Scheduler variance, CPU<->NIC contention",
        "Isolate runtime threads, pin NIC IRQs, increase batching window",
        D.EgressJitter, action="widen_batch_window",
        scenario="egress_jitter"),
    RunbookEntry(
        "egress_drop_retransmit", "3a", "Egress drop/retransmit",
        "Retransmissions or gaps in final response streams",
        "Egress",
        "Client-visible stalls; retries inflate latency",
        "NIC offload misconfig, fabric congestion, buffer underrun",
        "Check offload settings, enable congestion control (ECN/PFC)",
        D.EgressDropRetransmit, action="tune_transport",
        scenario="egress_retransmit"),
    RunbookEntry(
        "early_completion_skew", "3a", "Early completion skew",
        "Some egress flows terminate far earlier than peers",
        "Egress (multi-stream decode)",
        "Internode peers still busy; imbalance in final stages",
        "Early-stop on short sequences; no remap of freed resources",
        "Enable inflight remapping / load stealing for decode",
        D.EarlyCompletionSkew, action="inflight_remap",
        scenario="early_completion"),
    RunbookEntry(
        "ingress_egress_bandwidth_saturation", "3a",
        "Ingress/Egress bandwidth saturation",
        "NIC RX/TX at or near link capacity; queue buildup",
        "Ingress + Egress",
        "All internode phases elongated; cluster-level slowdown",
        "Shared NIC with storage/other jobs; insufficient link",
        "Upgrade NIC, QoS partitioning, stagger workloads",
        D.BandwidthSaturation, action="admission_control",
        scenario="nic_saturation"),
)

RUNBOOK_3B: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "h2d_data_starvation", "3b", "H2D data starvation",
        "Large/clustered H2D DMAs followed by long gaps before "
        "doorbells/kernels",
        "Ingress -> PCIe (prefill & decode input feed)",
        "Fewer/late internode bursts; downstream TP/PP idles",
        "PCIe BW cap, NUMA miss, pageable (unpinned) host buffers",
        "Pin memory, bind to correct NUMA socket, verify PCIe link "
        "width/speed",
        D.H2DDataStarvation, action="pin_and_coalesce",
        scenario="h2d_starvation"),
    RunbookEntry(
        "d2h_return_bottleneck", "3b", "D2H return-path bottleneck",
        "D2H DMAs linger / complete slowly; backlog after kernels",
        "Egress (logits/tokens back to host)",
        "Late responses; backpressure into next token step",
        "PCIe saturation, IOMMU contention, CPU copy hotspots",
        "Enable large pinned buffers, reduce copies, check IOMMU/ATS config",
        D.D2HReturnBottleneck, action="pin_and_coalesce",
        scenario="d2h_bottleneck"),
    RunbookEntry(
        "kernel_launch_control_latency", "3b", "Kernel launch/control latency",
        "Doorbells sporadic; long idle gaps between small H2D bursts and "
        "next launch",
        "Compute (GPU underutilized across prefill/decode)",
        "TP collectives delayed, PP handoffs drift",
        "Runtime overhead, CPU scheduler delays, too many tiny kernels",
        "Batch ops, fuse kernels, raise runtime launch queues, isolate CPU "
        "cores",
        D.KernelLaunchLatency, action="batch_launches",
        scenario="launch_latency"),
    RunbookEntry(
        "intra_node_gpu_skew", "3b", "Intra-node GPU skew",
        "One GPU shows thin/irregular DMA; peers steady",
        "Compute (per-layer) -> propagates to internode",
        "TP collectives widen (straggler), PP stage misalignment",
        "Uneven microbatching, memory pressure on a single GPU",
        "Rebalance microbatches, unify stream priorities, check that GPU's "
        "memory and clocks",
        D.IntraNodeGpuSkew, action="rebalance_microbatches",
        scenario="intra_node_skew"),
    RunbookEntry(
        "pcie_link_saturation", "3b", "PCIe link saturation",
        "Sustained near-peak PCIe throughput; compute stalls periodically",
        "Ingress -> PCIe, Egress",
        "Burstiness in internode waves; elongates token step",
        "Oversubscribed PCIe switch / x8 link, competing DMAs (storage/NIC)",
        "Verify x16 Gen/lanes, move devices off shared switch, stagger I/O",
        D.PCIeLinkSaturation, action="stagger_io",
        scenario="pcie_saturation"),
    RunbookEntry(
        "gpu_p2p_throttling", "3b", "GPU P2P throttling (PCIe)",
        "P2P DMAs slow/variable; no NVLink path",
        "Compute (intra-box TP/PP)",
        "Internode timing jitter (collectives wait on slow intra-box move)",
        "Shared uplink on PCIe switch; ACS/ATS settings",
        "Prefer NVLink/NVSwitch; if PCIe, place GPUs under same switch, "
        "tune ACS/ATS",
        D.GpuP2PThrottling, action="replace_topology",
        scenario="p2p_throttling"),
    RunbookEntry(
        "pinned_memory_shortage", "3b",
        "Pinned-memory shortage / fragmentation",
        "Many small DMAs vs large coalesced; rising DMA count",
        "Ingress -> PCIe (feed) and Egress (returns)",
        "Micro-jitter; uneven stage timing",
        "Insufficient pinned pools; fallback to pageable",
        "Pre-allocate larger pinned pools; coalesce transfers",
        D.PinnedMemoryShortage, action="pin_and_coalesce",
        scenario="pinned_shortage"),
    RunbookEntry(
        "host_cpu_bottleneck", "3b", "Host CPU bottleneck",
        "Low DMA rate despite available PCIe BW; delayed doorbells",
        "Compute orchestration",
        "Irregular TP cadence; PP bubbles",
        "CPU contention, IRQ affinity, polling disabled",
        "Isolate IRQs/threads, enable busy-poll where appropriate, pin "
        "runtime threads",
        D.HostCpuBottleneck, action="isolate_host_threads",
        scenario="host_cpu_bottleneck"),
    RunbookEntry(
        "memory_registration_churn", "3b", "Memory registration churn",
        "Frequent map/unmap patterns around DMAs",
        "Ingress -> PCIe",
        "Small timing gaps accumulating per token",
        "Repeated registration due to short-lived buffers",
        "Reuse registered buffers; RDMA/GPUDirect with persistent MR",
        D.MemoryRegistrationChurn, action="pin_and_coalesce",
        scenario="registration_churn"),
    RunbookEntry(
        "decode_early_stop_skew", "3b", "Decode early-stop skew",
        "D2H drops off early on some streams/GPUs",
        "Compute (decode) -> Egress",
        "Some peers go silent; collectives wait for remaining peers",
        "Sequence length variance; scheduler not rebalancing",
        "Enable inflight request remapping/packing; speculative decode "
        "policies",
        D.DecodeEarlyStopSkew, action="inflight_remap",
        scenario="decode_early_stop",
        # the same early-stop pathology seen at the N-S vantage; whichever
        # row confirms first drives the identical inflight_remap actuation,
        # so recovery credited to the sibling is this row's recovery too
        sibling_rows=("early_completion_skew",)),
)

RUNBOOK_3C: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "tp_straggler", "3c", "TP straggler",
        "Wide arrival spread of collective bursts (max-min arrival gap up)",
        "Compute (tensor-parallel collectives)",
        "Collective ops stall waiting for slowest peer",
        "Skewed GPU load, PCIe starvation, memory imbalance on one node",
        "Rebalance shards, check PCIe feeds per node, adjust affinity",
        D.TPStraggler, action="rebalance_shards",
        scenario="tp_straggler"),
    RunbookEntry(
        "pp_bubble_stage_stall", "3c", "PP bubble / stage stall",
        "Large or growing gaps between stage handoff bursts",
        "Pipeline parallel",
        "Downstream stage idles; upstream builds backlog",
        "Load imbalance across pipeline stages, early token exit variance",
        "Adjust microbatch partitioning, reassign stages, speculative fill",
        D.PPBubble, action="repartition_stages",
        scenario="pp_bubble"),
    RunbookEntry(
        "cross_node_load_skew", "3c", "Cross-node load skew",
        "Uneven traffic volume per node for same collective",
        "TP/PP compute -> Internode",
        "Some nodes oversend/undersend; throughput uneven",
        "Shard imbalance, misaligned activation partitioning",
        "Validate shard sizes, rebalance across nodes",
        D.CrossNodeLoadSkew, action="rebalance_shards",
        scenario="cross_node_skew"),
    RunbookEntry(
        "network_congestion_oversubscription", "3c",
        "Network congestion / oversubscription",
        "Periodic spikes in latency + jitter across many links",
        "Internode transfers (collectives & stage handoff)",
        "Token step elongates cluster-wide",
        "Fat-tree oversubscription, ToR link hot spot",
        "Check fabric counters, enable adaptive routing, spread ranks",
        D.NetworkCongestion, action="reroute_traffic",
        scenario="network_congestion"),
    RunbookEntry(
        "head_of_line_blocking", "3c", "Head-of-line blocking",
        "Some streams stall while others flow; out-of-order bursts",
        "Collective streams / P2P flows",
        "Latency-sensitive ops delayed",
        "Shared queue depth exhaustion, RoCE/NIC queue imbalance",
        "Increase NIC queue depth, enable QoS/ECN, verify fair sharing",
        D.HeadOfLineBlocking, action="qos_partition",
        scenario="hol_blocking"),
    RunbookEntry(
        "retransmissions_packet_loss", "3c", "Retransmissions / packet loss",
        "Gaps + duplicate traffic or sudden retransmit storms",
        "All distributed phases",
        "Bursty latency; collectives jitter",
        "Fabric errors, congestion collapse, misconfigured PFC",
        "Verify lossless config, tune buffer thresholds, check "
        "optics/cabling",
        D.EWRetransmitStorm, action="tune_transport",
        scenario="ew_retransmit"),
    RunbookEntry(
        "credit_starvation", "3c", "Credit starvation (RDMA/flow control)",
        "Long silence periods until remote credit update",
        "Internode (RDMA ops)",
        "Under-utilized links; token latency grows",
        "Too-small RDMA window, NIC credit depletion",
        "Increase QP window, tune flow control params",
        D.CreditStarvation, action="widen_rdma_window",
        scenario="credit_starvation"),
    RunbookEntry(
        "kv_cache_transfer_bottleneck", "3c", "KV-cache transfer bottleneck",
        "Repeated large bursts for some tokens, others silent",
        "Decode phase (PP handoff)",
        "Uneven memory pressure per stage; downstream skew",
        "Sharded KV too large for link budget; non-uniform length",
        "Compress KV, shard differently, apply caching policies",
        D.KVCacheTransferBottleneck, action="compress_kv",
        scenario="kv_bottleneck"),
    RunbookEntry(
        "early_stop_skew_across_nodes", "3c", "Early-stop skew across nodes",
        "Some nodes stop sending mid-iteration while others continue",
        "Decode (multi-node)",
        "Collectives/pipeline hang waiting for peers",
        "Sequence length divergence; scheduler not masking early exits",
        "Enable dynamic remapping, mask early-stop ranks",
        D.EarlyStopSkewAcrossNodes, action="inflight_remap",
        scenario="node_early_stop"),
)

RUNBOOK_3D: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "cross_replica_skew", "3d", "Cross-replica load skew (DP routing)",
        "Per-replica egress token rates diverge; one replica's ingress "
        "queue grows while peers drain",
        "Ingress routing -> decode (data-parallel replicas)",
        "Hot replica saturates; cold replicas idle; cluster p99 TTFT "
        "inflates while aggregate utilization looks normal",
        "Router policy imbalance (static round-robin under skewed flows), "
        "stale router view, session affinity pinning, degraded replica",
        "Rebalance queued requests across replicas; switch to queue/KV-aware "
        "routing; refresh or bound router view staleness",
        D.CrossReplicaSkew, action="rebalance_replicas",
        scenario="hot_replica"),
    RunbookEntry(
        "hierarchical_routing_skew", "3d",
        "Hierarchical routing skew (intra-replica node placement)",
        "One node inside a replica receives most of the replica's ingress "
        "request volume and its queue outgrows its siblings, while "
        "replica-level totals stay balanced",
        "Ingress routing -> intra-replica node placement (decode)",
        "The replica's other nodes idle while one saturates; TP-group "
        "throughput halves with no replica-tier signal",
        "Replica-local placement affinity (sticky session hashing, broken "
        "TP-group spread), node-granularity-blind router view",
        "Rebalance queued requests across the replica's nodes; restore the "
        "intra-replica spread; route at node granularity",
        D.HierarchicalRoutingSkew, action="rebalance_nodes",
        scenario="hierarchical_routing_skew"),
)

RUNBOOK_3E: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "collective_straggler", "3e",
        "Per-collective straggler (op-level finish lag)",
        "One node's per-op finish edge (all-gather / reduce-scatter) "
        "trails the group median round after round",
        "Compute (per-collective ops within the token step)",
        "Every op in the lagging rank's groups stretches to its finish; "
        "the aggregate round cadence hides which op pays",
        "Device slowdown or local contention on one rank, visible only at "
        "per-op granularity (the merged round burst averages it away)",
        "Rebalance shards toward the lagging rank; verify its local feeds "
        "and clocks",
        D.CollectiveStragglerLag, action="rebalance_shards",
        scenario="collective_straggler"),
    RunbookEntry(
        "rail_congestion", "3e",
        "Rail congestion (cross-domain tier)",
        "Cross-domain collective legs sharing one rail finish consistently "
        "later than legs on sibling rails",
        "Internode transfers (cross-domain rail tier)",
        "Ops spanning NVLink-class domains serialize on the hot rail; "
        "intra-domain traffic stays fast, so node-keyed rows stay quiet",
        "Oversubscribed or degraded rail shared by all cross-domain legs "
        "(DWDP-style rail-aligned topology)",
        "Reroute cross-domain legs off the hot rail; respread ranks over "
        "rails",
        D.RailCongestion, action="reroute_rail",
        scenario="rail_congestion"),
    RunbookEntry(
        "hbm_bandwidth_cliff", "3e",
        "Memory-bandwidth cliff (decode batch knee)",
        "Per-node egress token rate sags well below its own peak while "
        "ingress queues stay flat and batch occupancy sits at max",
        "Decode (device memory bandwidth)",
        "Throughput sags cluster-wide with no queue growth anywhere — "
        "every queue- and gap-keyed row stays silent",
        "Decode batch size past the device's memory-bandwidth knee; token "
        "rate saturates at the bandwidth ceiling",
        "Shrink the decode batch below the knee; re-spread slots across "
        "nodes",
        D.HbmBandwidthCliff, action="shrink_batch",
        scenario="hbm_bandwidth_cliff"),
)

RUNBOOK_DPU: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "dpu_saturation", "dpu", "DPU telemetry-plane saturation",
        "On-DPU ingest ring fills; event batches shed; ring occupancy "
        "pinned high while shed counters climb",
        "Telemetry plane (all vantages degraded)",
        "Findings arrive late or never, cluster-wide; the mitigation loop "
        "reacts to a stale picture",
        "Event volume exceeds the DPU's ingest/compute budget (verbose "
        "debug tap, line-rate burst, undersized budget)",
        "Raise tap sampling stride; shed low-priority event classes; "
        "bound per-class event rates at the source",
        D.DPUSaturation, action="throttle_telemetry",
        scenario="dpu_saturation"),
)

RUNBOOK_MON: tuple[RunbookEntry, ...] = (
    RunbookEntry(
        "dpu_outage", "mon", "DPU outage (monitoring plane dark)",
        "Watchdog heartbeat probes to the DPU go silent past the timeout "
        "(no self-telemetry cadence, no command-bus acks) over the "
        "out-of-band management port",
        "Monitoring plane (all detection and actuation dark)",
        "Every runbook row is blind for the outage; faults progress "
        "unmitigated until the plane returns or a fallback takes over",
        "DPU crash, hang, or power-cycle; firmware fault; management-path "
        "loss of the telemetry sidecar",
        "Fail over to the degraded host-side controller (high-confidence "
        "rows only); fail back with hysteresis when heartbeats resume; "
        "quarantine the restarted DPU until its detectors re-warm",
        D.DPUOutage, action="failover_controller",
        scenario="dpu_outage"),
    RunbookEntry(
        "telemetry_blackout", "mon", "Telemetry blackout (ingest gap)",
        "The DPU's ingest guard sees a jump in the tap's batch sequence "
        "numbers (or checksum-corrupt/replayed frames) after an uplink "
        "partition window",
        "Telemetry ingest (detection blind for the gap window)",
        "Detector state spans a hole in the stream; rate/gap baselines "
        "are stale and any actuation off them risks a false command",
        "Uplink partition or blackout between the host tap and the DPU; "
        "frame corruption or replay on the telemetry path",
        "Re-register the tap and resync the sequence stream; quarantine "
        "actuation until detectors re-warm over fresh events",
        D.TelemetryBlackout, action="resync_telemetry",
        scenario="telemetry_blackout"),
    RunbookEntry(
        "command_partition", "mon", "Command-channel partition",
        "Commands and liveness pings burn every retry unacked while "
        "telemetry ingest stays healthy — the loop can see but not act",
        "Actuation path (detection intact, mitigation dark)",
        "Confirmed pathologies accumulate without mitigation; retry "
        "exhaustion climbs with zero intervening acks",
        "Downlink/ack-channel partition between the DPU and the host "
        "actuator (control fabric shares the data fabric's failure domain)",
        "Fail actuation over to the host-side controller until the "
        "command channel round-trips again",
        D.CommandPartition, action="failover_controller",
        scenario="command_partition"),
    RunbookEntry(
        "standby_lag", "mon", "Standby shadow lag (redundancy degraded)",
        "The standby sidecar's tap clock falls a sustained quarter-second "
        "or more behind the primary's while the primary stays healthy — "
        "the mirrored tap leg is dropping or partitioned",
        "Monitoring plane (hot-failover guarantee silently void)",
        "Detection continues on the primary, but a failover right now "
        "would promote detectors warm on stale state; the deployment is "
        "one primary fault away from a cold promotion",
        "Standby uplink partition/blackout on the fan-out leg, or a "
        "wedged standby sidecar with a live primary",
        "Re-mirror the standby from the watchdog's retained tap history "
        "and resync its sequence stream; alert if lag recurs",
        D.StandbyLag, action="remirror_standby",
        scenario="standby_lag"),
    RunbookEntry(
        "split_brain_fenced", "mon", "Split-brain fenced (stale-term "
        "command rejected)",
        "The host actuator rejects commands stamped with a lease term "
        "older than the granted one — a deposed sidecar is alive and "
        "still trying to actuate",
        "Actuation path (double-actuation attempt blocked at the fence)",
        "Two controllers believe they lead; only the term fence prevents "
        "conflicting mitigations racing each other on the same nodes",
        "OOB management-port partition hid the demotion from the old "
        "leader while its command downlink stayed alive",
        "Deliver the current term to the stale sidecar (quiesce it) and "
        "purge its outstanding commands; audit the fencing log",
        D.SplitBrainFenced, action="fence_stale_controller",
        scenario="split_brain_fenced"),
)

#: every table the full DPU agent runs (the paper's three runbooks, the
#: 3d data-parallel extension, the 3e per-collective/topology tier, the
#: plane's self-diagnosis row, and the monitoring-plane robustness rows)
DEFAULT_TABLES: tuple[str, ...] = ("3a", "3b", "3c", "3d", "3e", "dpu",
                                   "mon")

ALL_RUNBOOKS: tuple[RunbookEntry, ...] = (
    RUNBOOK_3A + RUNBOOK_3B + RUNBOOK_3C + RUNBOOK_3D + RUNBOOK_3E
    + RUNBOOK_DPU + RUNBOOK_MON)

BY_ID: dict[str, RunbookEntry] = {e.row_id: e for e in ALL_RUNBOOKS}
BY_TABLE: dict[str, tuple[RunbookEntry, ...]] = {
    "3a": RUNBOOK_3A, "3b": RUNBOOK_3B, "3c": RUNBOOK_3C, "3d": RUNBOOK_3D,
    "3e": RUNBOOK_3E, "dpu": RUNBOOK_DPU, "mon": RUNBOOK_MON,
}


def row_hit(row_id: str, fired: set[str]) -> bool:
    """Did this row's pathology get caught — by the row itself or by one of
    its declared ``sibling_rows``?  The control-loop gates use this: when
    two rows watch one pathology from different vantages, whichever
    confirms first drives the (shared) actuation, and demanding the
    canonical row's own name would fail a loop that in fact recovered."""
    if row_id in fired:
        return True
    entry = BY_ID.get(row_id)
    return entry is not None and bool(set(entry.sibling_rows) & fired)


def build_detectors(cfg: DetectorConfig | None = None,
                    tables: tuple[str, ...] = DEFAULT_TABLES,
                    ) -> dict[str, Detector]:
    """Instantiate one detector per runbook row (the full DPU agent)."""
    cfg = cfg or DetectorConfig()
    return {
        e.row_id: e.detector_cls(cfg)
        for t in tables
        for e in BY_TABLE[t]
    }
