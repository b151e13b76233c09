"""Cross-vantage root-cause attribution — the paper's §4.2 logic, executable.

The paper's key observation: a single vantage point sees a *symptom*; the
combination of North-South, PCIe, and East-West vantage points localizes the
*cause*:

  "if one GPU consistently exhibits delayed PCIe activity after ingress, the
   DPU can attribute the slowdown to local imbalance (CPU preprocessing lag,
   PCIe congestion) rather than network effects.  Conversely, if PCIe
   patterns are healthy but responses stall at egress, the issue is likely
   network-side."

We encode this as a small rule engine over the set of active findings within
a correlation window.  Output is an ``Attribution`` naming the *locus* (where
the skew is introduced) and the chain of findings supporting it — exactly the
"root-cause attribution: host-to-GPU transfers, GPU scheduling, or external
communication?" question the paper poses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.detectors import Finding

# Loci ordered roughly along the request lifecycle.
LOCUS_INGRESS = "ingress_path"          # client -> NIC
LOCUS_HOST = "host_cpu"                 # tokenize/batch/launch on host
LOCUS_PCIE = "pcie_transfer"            # host <-> device feed/return
LOCUS_DEVICE = "device_scheduling"      # per-device load imbalance
LOCUS_NETWORK = "internode_network"     # E-W fabric
LOCUS_EGRESS = "egress_path"            # NIC -> client
LOCUS_WORKLOAD = "workload_shape"       # seq-length variance, early stop
LOCUS_ROUTER = "router_dispatch"        # DP-replica routing layer
LOCUS_DPU = "telemetry_plane"           # the observer itself is overloaded
LOCUS_UNKNOWN = "unknown"

#: finding name -> the locus that finding is *direct* evidence for
DIRECT_LOCUS: dict[str, str] = {
    # 3a
    "burst_admission_backlog": LOCUS_INGRESS,
    "ingress_starvation": LOCUS_INGRESS,
    "flow_skew_across_sessions": LOCUS_INGRESS,
    "ingress_drop_retransmit": LOCUS_INGRESS,
    "egress_backlog_queueing": LOCUS_EGRESS,
    "egress_jitter": LOCUS_EGRESS,
    "egress_drop_retransmit": LOCUS_EGRESS,
    "early_completion_skew": LOCUS_WORKLOAD,
    "ingress_egress_bandwidth_saturation": LOCUS_INGRESS,
    # 3b
    "h2d_data_starvation": LOCUS_PCIE,
    "d2h_return_bottleneck": LOCUS_PCIE,
    "kernel_launch_control_latency": LOCUS_HOST,
    "intra_node_gpu_skew": LOCUS_DEVICE,
    "pcie_link_saturation": LOCUS_PCIE,
    "gpu_p2p_throttling": LOCUS_PCIE,
    "pinned_memory_shortage": LOCUS_HOST,
    "host_cpu_bottleneck": LOCUS_HOST,
    "memory_registration_churn": LOCUS_HOST,
    "decode_early_stop_skew": LOCUS_WORKLOAD,
    # 3c
    "tp_straggler": LOCUS_NETWORK,        # symptom is E-W; cause often local
    "pp_bubble_stage_stall": LOCUS_NETWORK,
    "cross_node_load_skew": LOCUS_DEVICE,
    "network_congestion_oversubscription": LOCUS_NETWORK,
    "head_of_line_blocking": LOCUS_NETWORK,
    "retransmissions_packet_loss": LOCUS_NETWORK,
    "credit_starvation": LOCUS_NETWORK,
    "kv_cache_transfer_bottleneck": LOCUS_NETWORK,
    "early_stop_skew_across_nodes": LOCUS_WORKLOAD,
    # 3d
    "cross_replica_skew": LOCUS_ROUTER,
    "hierarchical_routing_skew": LOCUS_ROUTER,
    # 3e
    "collective_straggler": LOCUS_DEVICE,
    "rail_congestion": LOCUS_NETWORK,
    "hbm_bandwidth_cliff": LOCUS_DEVICE,
    # DPU self-diagnosis
    "dpu_saturation": LOCUS_DPU,
    # monitoring-plane robustness (mon)
    "dpu_outage": LOCUS_DPU,
    "telemetry_blackout": LOCUS_DPU,
    "command_partition": LOCUS_DPU,
    "standby_lag": LOCUS_DPU,
    "split_brain_fenced": LOCUS_DPU,
}


@dataclass(frozen=True)
class Attribution:
    """Root-cause verdict for one correlated incident."""

    ts: float
    locus: str                      # one of the LOCUS_* constants
    node: int                       # offending node, -1 = cluster-wide
    confidence: float               # 0..1
    primary: Finding                # the symptom that triggered correlation
    supporting: tuple[Finding, ...] # co-occurring evidence
    narrative: str                  # human-readable §4.2-style explanation


class Attributor:
    """Correlates findings within a sliding window and applies §4.2 rules.

    Rule order matters: the most specific cross-vantage patterns first, the
    direct single-vantage mapping as fallback.
    """

    def __init__(self, window: float = 2.0) -> None:
        self.window = window
        self._recent: list[Finding] = []
        self.attributions: list[Attribution] = []

    # -- feeding ---------------------------------------------------------

    def observe(self, findings: list[Finding]) -> list[Attribution]:
        out = []
        for f in findings:
            self._recent.append(f)
            a = self._attribute(f)
            if a is not None:
                self.attributions.append(a)
                out.append(a)
        if self._recent:
            horizon = self._recent[-1].ts - self.window
            self._recent = [f for f in self._recent if f.ts >= horizon]
        return out

    # -- rules -----------------------------------------------------------

    def _within(self, f: Finding, names: set[str],
                same_node: bool = False) -> list[Finding]:
        return [
            g for g in self._recent
            if g.name in names and abs(g.ts - f.ts) <= self.window
            and (not same_node or g.node == f.node or g.node < 0 or f.node < 0)
        ]

    def _attribute(self, f: Finding) -> Attribution | None:
        # Rule 1 (§4.2 verbatim): E-W straggler symptom + delayed/unhealthy
        # PCIe on the same node => LOCAL imbalance, not network.
        if f.name in ("tp_straggler", "pp_bubble_stage_stall",
                      "cross_node_load_skew"):
            local = self._within(f, {
                "h2d_data_starvation", "d2h_return_bottleneck",
                "pcie_link_saturation", "intra_node_gpu_skew",
                "host_cpu_bottleneck", "kernel_launch_control_latency",
                "pinned_memory_shortage", "memory_registration_churn",
            }, same_node=True)
            if local:
                locus = DIRECT_LOCUS[local[0].name]
                return Attribution(
                    f.ts, locus, node=max(f.node, local[0].node),
                    confidence=0.9, primary=f, supporting=tuple(local),
                    narrative=(
                        f"E-W symptom '{f.name}' co-occurs with local "
                        f"'{local[0].name}' on node {local[0].node}: skew is "
                        f"introduced host-side ({locus}), not by the fabric."))
            # straggler with *healthy* PCIe on all nodes => fabric or device
            fabric = self._within(f, {
                "network_congestion_oversubscription",
                "retransmissions_packet_loss", "head_of_line_blocking",
                "credit_starvation"})
            if fabric:
                return Attribution(
                    f.ts, LOCUS_NETWORK, node=-1, confidence=0.85,
                    primary=f, supporting=tuple(fabric),
                    narrative=(
                        f"E-W symptom '{f.name}' coincides with fabric "
                        f"pathology '{fabric[0].name}': network-side cause."))
            workload = self._within(f, {
                "early_completion_skew", "decode_early_stop_skew",
                "early_stop_skew_across_nodes"})
            if workload:
                return Attribution(
                    f.ts, LOCUS_WORKLOAD, node=f.node, confidence=0.8,
                    primary=f, supporting=tuple(workload),
                    narrative=(
                        f"Collective stall '{f.name}' explained by sequence-"
                        "length divergence (early-stop) — scheduler issue, "
                        "not infrastructure."))
            return Attribution(
                f.ts, LOCUS_DEVICE, node=f.node, confidence=0.5,
                primary=f, supporting=(),
                narrative=(
                    f"'{f.name}' with healthy PCIe and quiet fabric: "
                    "attribute to device-level load imbalance (default)."))

        # Rule 2 (§4.2 verbatim): egress stalls with healthy PCIe => network.
        if f.name in ("egress_backlog_queueing", "egress_jitter",
                      "egress_drop_retransmit"):
            pcie_sick = self._within(f, {
                "d2h_return_bottleneck", "pcie_link_saturation",
                "host_cpu_bottleneck"}, same_node=True)
            if pcie_sick:
                locus = DIRECT_LOCUS[pcie_sick[0].name]
                return Attribution(
                    f.ts, locus, node=f.node, confidence=0.85, primary=f,
                    supporting=tuple(pcie_sick),
                    narrative=(
                        f"Egress symptom '{f.name}' with sick return path "
                        f"'{pcie_sick[0].name}': host/PCIe-side cause."))
            return Attribution(
                f.ts, LOCUS_EGRESS, node=f.node, confidence=0.75, primary=f,
                supporting=(),
                narrative=(
                    f"Egress symptom '{f.name}' with healthy PCIe patterns: "
                    "issue is likely network/NIC-side (paper §4.2)."))

        # Rule 3: H2D starvation — distinguish upstream (thin ingress) from
        # host-side (ingress fine, feed broken).
        if f.name == "h2d_data_starvation":
            thin = self._within(f, {"ingress_starvation",
                                    "burst_admission_backlog"},
                                same_node=True)
            if thin:
                return Attribution(
                    f.ts, LOCUS_INGRESS, node=f.node, confidence=0.85,
                    primary=f, supporting=tuple(thin),
                    narrative=(
                        "Device feed starves because ingress itself is "
                        f"pathological ('{thin[0].name}'): upstream cause."))
            host = self._within(f, {"host_cpu_bottleneck",
                                    "pinned_memory_shortage",
                                    "memory_registration_churn"},
                                same_node=True)
            if host:
                return Attribution(
                    f.ts, LOCUS_HOST, node=f.node, confidence=0.85,
                    primary=f, supporting=tuple(host),
                    narrative=(
                        "Ingress healthy but device feed starves alongside "
                        f"'{host[0].name}': host-side preprocessing/feed "
                        "bottleneck (CPU tokenization/batching lag)."))
            return Attribution(
                f.ts, LOCUS_PCIE, node=f.node, confidence=0.6, primary=f,
                supporting=(),
                narrative="Isolated H2D starvation: PCIe transfer path.")

        # Rule 4: early-stop family is always a workload/scheduler issue.
        if f.name in ("early_completion_skew", "decode_early_stop_skew",
                      "early_stop_skew_across_nodes"):
            return Attribution(
                f.ts, LOCUS_WORKLOAD, node=f.node, confidence=0.9, primary=f,
                supporting=(),
                narrative=(
                    "Early-stop skew: sequence-length variance leaves shards "
                    "idle; mitigation is scheduler-side (inflight remap)."))

        # Rule 5: cross-replica skew — if ingress itself is pathological the
        # imbalance is upstream; with clean ingress it is the router's doing
        # (bad policy, stale view, or a degraded replica the router keeps
        # feeding).
        if f.name == "cross_replica_skew":
            upstream = self._within(f, {
                "ingress_starvation", "flow_skew_across_sessions",
                "burst_admission_backlog"})
            if upstream:
                return Attribution(
                    f.ts, LOCUS_INGRESS, node=f.node, confidence=0.8,
                    primary=f, supporting=tuple(upstream),
                    narrative=(
                        f"Replica skew co-occurs with '{upstream[0].name}': "
                        "the imbalance originates upstream of the router."))
            return Attribution(
                f.ts, LOCUS_ROUTER, node=f.node, confidence=0.85, primary=f,
                supporting=(),
                narrative=(
                    "Ingress healthy but per-replica egress rates diverge "
                    f"and replica {f.node}'s queue grows: the DP routing "
                    "layer is concentrating load (policy/staleness/affinity)."))

        # Rule 5b: intra-replica node skew with replica-balanced ingress is
        # the placement layer's doing by construction — unless the hot node
        # itself is locally sick (then the router is feeding a degraded
        # node, which is a device/host problem wearing routing clothes).
        if f.name == "hierarchical_routing_skew":
            local = self._within(f, {
                "h2d_data_starvation", "host_cpu_bottleneck",
                "intra_node_gpu_skew", "pcie_link_saturation"},
                same_node=True)
            if local:
                locus = DIRECT_LOCUS[local[0].name]
                return Attribution(
                    f.ts, locus, node=f.node, confidence=0.8, primary=f,
                    supporting=tuple(local),
                    narrative=(
                        f"Node {f.node} hoards its replica's requests AND "
                        f"shows local '{local[0].name}': the node is "
                        "degraded; placement skew is a symptom."))
            return Attribution(
                f.ts, LOCUS_ROUTER, node=f.node, confidence=0.85, primary=f,
                supporting=(),
                narrative=(
                    f"Replica totals balanced but node {f.node} receives "
                    f"{f.evidence.get('ingress_share', '?')} of its "
                    "replica's ingress and its queue outgrows its "
                    "siblings: intra-replica placement skew — the routing "
                    "layer is blind below the replica tier."))

        # Rule 5c: the per-collective tier (3e) carries its locus in the
        # signal's construction.  An op-level straggler names a rank;
        # rail congestion names a shared link, never a node; the memory-
        # bandwidth cliff is the only row whose evidence *includes* the
        # batch size that explains the sag, so the narrative says so.
        if f.name == "collective_straggler":
            return Attribution(
                f.ts, LOCUS_DEVICE, node=f.node, confidence=0.75, primary=f,
                supporting=(),
                narrative=(
                    f"Node {f.node} is last into "
                    f"{f.evidence.get('late_frac', '?')} of its per-op "
                    "collective rounds: rank-local slowdown visible only at "
                    "per-op granularity."))
        if f.name == "rail_congestion":
            return Attribution(
                f.ts, LOCUS_NETWORK, node=-1, confidence=0.8, primary=f,
                supporting=(),
                narrative=(
                    f"Rail {f.evidence.get('rail', '?')} is the slow rail in "
                    f"{f.evidence.get('slow_frac', '?')} of cross-domain "
                    "rounds while intra-domain traffic stays fast: a shared-"
                    "rail fabric problem, not any single rank."))
        if f.name == "hbm_bandwidth_cliff":
            return Attribution(
                f.ts, LOCUS_DEVICE, node=f.node, confidence=0.8, primary=f,
                supporting=(),
                narrative=(
                    f"Node {f.node}'s egress rate sags to "
                    f"{f.evidence.get('rate_vs_peak', '?')} of its peak with "
                    "a flat ingress queue and batch occupancy of "
                    f"{f.evidence.get('batch_size', '?')} at its observed "
                    "max: decode batch size is past the device's memory-"
                    "bandwidth knee — shrink the batch, nothing upstream "
                    "will help."))

        # Rule 6: the observer itself saturating is always self-attributed —
        # and it taints confidence in everything else this window, so it
        # carries high confidence of its own locus.
        if f.name == "dpu_saturation":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.9, primary=f,
                supporting=(),
                narrative=(
                    "DPU ingest budget saturated (ring "
                    f"{f.evidence.get('ring_occupancy_pct', '?')}%, "
                    f"{f.evidence.get('shed_rows', 0)} rows shed): the "
                    "telemetry plane is degraded; concurrent findings may "
                    "be late or missing — shed load at the tap."))

        # Rule 7: monitoring-plane failures self-attribute like Rule 6 —
        # the signal sources (watchdog probes, ingest-guard latch, bus
        # exhaustion counters) exist only on the monitoring path, so no
        # cross-vantage correlation can sharpen or overturn them.  They
        # also taint everything else this window: findings spanning the
        # blind interval ride stale baselines.
        if f.name == "dpu_outage":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.9, primary=f,
                supporting=(),
                narrative=(
                    "DPU heartbeats silent for "
                    f"{f.evidence.get('silence_ms', '?')} ms across "
                    f"{f.evidence.get('silent_probes', '?')} probes: the "
                    "monitoring plane itself is down — fail over to the "
                    "degraded host-side controller."))
        if f.name == "telemetry_blackout":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.85, primary=f,
                supporting=(),
                narrative=(
                    "Telemetry stream tore: "
                    f"{f.evidence.get('lost_batches', '?')} batches "
                    "missing or corrupt since the last resync "
                    f"({f.evidence.get('replays_dropped', 0)} replays "
                    "dropped).  Detector baselines span a hole — resync "
                    "the tap; actuation stays quarantined meanwhile."))
        if f.name == "command_partition":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.9, primary=f,
                supporting=(),
                narrative=(
                    "Command channel partitioned: "
                    f"{f.evidence.get('exhausted_commands', '?')} commands "
                    "burned every retry unacked "
                    f"({f.evidence.get('retries', '?')} resends total). "
                    "Detection is intact but mitigation is dark — fail "
                    "actuation over host-side."))
        if f.name == "standby_lag":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.85, primary=f,
                supporting=(),
                narrative=(
                    "Hot standby lagging the primary by "
                    f"{f.evidence.get('lag_ms', '?')} ms of tap time: the "
                    "mirrored fan-out leg is degraded and a failover now "
                    "would promote stale detector state — re-mirror the "
                    "standby from retained tap history."))
        if f.name == "split_brain_fenced":
            return Attribution(
                f.ts, LOCUS_DPU, node=-1, confidence=0.9, primary=f,
                supporting=(),
                narrative=(
                    f"{f.evidence.get('fenced_commands', '?')} stale-term "
                    "command(s) fenced at the host actuator under term "
                    f"{f.evidence.get('granted_term', '?')}: a deposed "
                    "sidecar is alive and still actuating — quiesce it "
                    "with the current term and purge its outstanding "
                    "commands."))

        # Fallback: direct single-vantage mapping.
        locus = DIRECT_LOCUS.get(f.name, LOCUS_UNKNOWN)
        return Attribution(
            f.ts, locus, node=f.node, confidence=0.6, primary=f,
            supporting=(),
            narrative=f"Direct mapping: '{f.name}' -> {locus}.")
