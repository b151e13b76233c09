"""Fault injectors — one scenario per runbook row.

``SCENARIOS`` maps scenario name (as referenced by
``runbooks.RunbookEntry.scenario``) to a factory returning the
``FaultSpec`` + any workload override that realizes that row's pathology.
The registry is complete by construction: a test asserts every runbook row's
scenario exists here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.dpu import (  # noqa: F401 (LinkParams: views)
    DPUParams,
    LinkParams,
    WatchdogParams,
)
from repro_torch.sim.cluster import FaultSpec, SimParams
from repro_torch.sim.workload import WorkloadSpec


@dataclass
class Scenario:
    name: str
    row_id: str                    # runbook row this validates
    fault: FaultSpec
    workload: WorkloadSpec = field(default_factory=lambda: WorkloadSpec())
    params: SimParams = field(default_factory=lambda: SimParams())

    def variant(self, seed: int | None = None,
                scalar_synth: bool | None = None,
                scale: int = 1) -> "Scenario":
        """Fresh deep-copied scenario cell for a sweep/benchmark grid.

        ``seed`` reseeds both the sim and the workload (offset so the two
        generator families stay distinct); ``scalar_synth`` selects the
        synthesis path; ``scale`` multiplies node count and arrival rate
        (the line-rate benchmark axis).  The registry entry itself is
        never mutated — ``run_scenario`` flips fault state in place.
        """
        pkw: dict = {}
        wkw: dict = {}
        if seed is not None:
            pkw["seed"] = self.params.seed + 1009 * seed
            wkw["seed"] = self.workload.seed + 2003 * seed
        if scalar_synth is not None:
            pkw["scalar_synth"] = scalar_synth
        if scale != 1:
            pkw["n_nodes"] = self.params.n_nodes * scale
            wkw["rate"] = self.workload.rate * scale
        return Scenario(
            name=self.name, row_id=self.row_id,
            fault=dataclasses.replace(self.fault),
            workload=dataclasses.replace(self.workload, **wkw),
            params=dataclasses.replace(self.params, **pkw))


def _wl(**kw) -> WorkloadSpec:
    base = dict(rate=260.0, duration=1.8, decode_mean=48, seed=7)
    base.update(kw)
    return WorkloadSpec(**base)


def _pm(**kw) -> SimParams:
    base = dict(duration=2.0, seed=3)
    base.update(kw)
    return SimParams(**base)


def make_scenarios() -> dict[str, Scenario]:
    s: dict[str, Scenario] = {}

    def add(name: str, row_id: str, fault: FaultSpec,
            workload: WorkloadSpec | None = None,
            params: SimParams | None = None) -> None:
        fault.name = name
        fault.row_id = row_id
        s[name] = Scenario(name=name, row_id=row_id, fault=fault,
                           workload=workload or _wl(),
                           params=params or _pm())

    # ---------------- Table 3(a) ----------------
    # burst_factor 32: the np.random.Generator arrival stream needs a
    # sharper clump than the legacy random.Random one for the backlog
    # spike to land inside a single detector poll window (seed-robust:
    # fires clean on seeds 0-2 with no co-firings)
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("burst_admission", "burst_admission_backlog",
        FaultSpec(start=0.8),
        workload=_wl(burst_factor=32.0, burst_start=0.8, rate=260.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("ingress_starvation", "ingress_starvation",
        FaultSpec(ingress_starve_node=1))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("flow_skew", "flow_skew_across_sessions",
        FaultSpec(start=0.0),
        workload=_wl(flow_skew=1.5))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("ingress_retransmit", "ingress_drop_retransmit",
        FaultSpec(ingress_retx_p=0.25))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("egress_backlog", "egress_backlog_queueing",
        FaultSpec(egress_backlog_rate=3.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("egress_jitter", "egress_jitter",
        FaultSpec(egress_jitter_mult=30.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("egress_retransmit", "egress_drop_retransmit",
        FaultSpec(egress_retx_p=0.2))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("early_completion", "early_completion_skew",
        FaultSpec(start=0.0, early_stop_skew=True),
        workload=_wl(decode_cv=0.1, rate=200.0),
        params=_pm(duration=2.5, continuous_batching=False))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("nic_saturation", "ingress_egress_bandwidth_saturation",
        FaultSpec(nic_background_frac=1.1, egress_backlog_rate=1.5))

    # ---------------- Table 3(b) ----------------
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("h2d_starvation", "h2d_data_starvation",
        FaultSpec(h2d_stall_node=2, h2d_stall_mult=24.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("d2h_bottleneck", "d2h_return_bottleneck",
        FaultSpec(d2h_delay_mult=14.0, dispatch_jitter_mult=1.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("launch_latency", "kernel_launch_control_latency",
        FaultSpec(dispatch_jitter_mult=40.0, dispatch_delay=4e-3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("intra_node_skew", "intra_node_gpu_skew",
        FaultSpec(start=0.0, skew_device=(1, 2), skew_factor=0.08))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("pcie_saturation", "pcie_link_saturation",
        FaultSpec(pcie_background_frac=1.3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("p2p_throttling", "gpu_p2p_throttling",
        FaultSpec(p2p_slow_node=3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("pinned_shortage", "pinned_memory_shortage",
        FaultSpec(h2d_split=12))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("host_cpu_bottleneck", "host_cpu_bottleneck",
        FaultSpec(host_slow_node=0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("registration_churn", "memory_registration_churn",
        FaultSpec(reg_churn=True))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("decode_early_stop", "decode_early_stop_skew",
        FaultSpec(start=0.0, early_stop_skew=True, node_stop=-1),
        workload=_wl(decode_cv=0.05),
        params=_pm(duration=2.5, continuous_batching=False))

    # ---------------- Table 3(c) ----------------
    add("tp_straggler", "tp_straggler",
        FaultSpec(straggler_node=2, straggler_delay=1.2e-3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("pp_bubble", "pp_bubble_stage_stall",
        FaultSpec(stage_gap_growth=1.2e-4))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("cross_node_skew", "cross_node_load_skew",
        FaultSpec(start=0.0, collective_bytes_node=1,
                  collective_bytes_mult=6.0))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("network_congestion", "network_congestion_oversubscription",
        FaultSpec(fabric_jitter=2.5e-3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("hol_blocking", "head_of_line_blocking",
        FaultSpec(hol_stall_frac=0.3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("ew_retransmit", "retransmissions_packet_loss",
        FaultSpec(ew_retx_p=0.3))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("credit_starvation", "credit_starvation",
        FaultSpec(credit_starve=True))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("kv_bottleneck", "kv_cache_transfer_bottleneck",
        FaultSpec(kv_heavy=True))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("node_early_stop", "early_stop_skew_across_nodes",
        FaultSpec(node_stop=3, node_stop_at=1.2),
        params=_pm(duration=2.6))

    # ---------------- Table 3(d): data-parallel routing ----------------
    # one node per replica so the router's choice IS the load placement
    add("hot_replica", "cross_replica_skew",
        FaultSpec(hot_replica=2, hot_replica_frac=0.65),
        workload=_wl(rate=300.0, duration=2.9),
        params=_pm(duration=3.0, n_replicas=4,
                   router_policy="join_shortest_queue"))
    # low steady load + occasional microbursts: a fresh JSQ router spreads
    # each burst; a lagging view dumps the whole clump on one replica.
    # The staleness is no longer a knob: the fault degrades the router's
    # view *transport* (0.6 s delay + jitter + 5% loss on the modeled
    # link), so snapshots arrive late and out of order and the router's
    # measured view lag — not a configuration — disables its optimistic
    # accounting.  The healthy link (1.5 ms) is realistic but harmless.
    add("stale_router_view", "cross_replica_skew",
        FaultSpec(router_stale=0.6),
        workload=_wl(rate=45.0, duration=2.9, burst_factor=16.0),
        params=_pm(duration=3.0, n_replicas=4,
                   router_policy="join_shortest_queue",
                   view_link=LinkParams(delay=1.5e-3)))
    # intra-replica placement skew: every replica's requests stick to its
    # first node (a replica-local affinity bug) — replica totals stay
    # balanced (the 3d.1 detector stays silent) while each replica's node
    # tier skews hard; only the hierarchical row can see it
    add("hierarchical_routing_skew", "hierarchical_routing_skew",
        FaultSpec(intra_replica_pin_frac=0.85),
        workload=_wl(rate=260.0, duration=2.4),
        params=_pm(duration=2.5, n_replicas=2,
                   router_policy="join_shortest_queue"))
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("replica_slow", "cross_replica_skew",
        FaultSpec(replica_slow=1, replica_slow_mult=5.0),
        workload=_wl(rate=300.0, duration=2.9),
        params=_pm(duration=3.0, n_replicas=4,
                   router_policy="round_robin"))

    # ------- Table 3(e): collectives / rails / memory knee --------------
    # one node's per-op (AG/RS) finish edges lag the group median on every
    # op round — invisible in the aggregate TP burst, which stays on time
    add("collective_straggler", "collective_straggler",
        FaultSpec(collective_lag_node=1, collective_lag=1.5e-3),
        params=_pm(per_collective=True))
    # one rail's bandwidth is cut: every cross-domain leg riding it slows
    # 6x, whichever node it came from — congestion with no per-node locus
    add("rail_congestion", "rail_congestion",
        FaultSpec(rail_cut=1, rail_cut_mult=6.0),
        params=_pm(rail_domain_size=2))
    # the effective memory-bandwidth knee collapses under the steady batch:
    # token rate saturates (deep sag vs the pre-fault peak) while request
    # queues stay flat — the latency cliff with no queueing signature.
    # Long decodes keep the queue drift under the detector's flat-queue
    # ceiling across the fault window.
    add("hbm_bandwidth_cliff", "hbm_bandwidth_cliff",
        FaultSpec(hbm_knee_shift=2),
        workload=_wl(rate=32.0, decode_mean=384),
        params=_pm(hbm_knee=12))

    # ---------------- DPU control plane ----------------
    # The sidecar's own pathologies: these run with ``control="dpu"`` so the
    # registry test and the golden fixtures exercise the asynchronous loop.
    # Healthy synthesis is ~90 rows/round at canonical scale; the debug-tap
    # storm adds 256 rows/round against a 100k rows/s (200 rows/round)
    # budget, so the ingest ring fills within ~30 rounds of fault start and
    # the DPU begins shedding — its self-telemetry is the only signal that
    # survives, which is the point of the row.
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("dpu_saturation", "dpu_saturation",
        FaultSpec(telemetry_flood=256.0),
        params=_pm(control="dpu",
                   dpu=DPUParams(events_per_s=1e5, ring_events=4096)))
    # command-channel loss: detection is clean (uplink untouched) but every
    # mitigation command flips a coin — recovery leans on the bus's
    # ack-timeout retries
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("lossy_command_channel", "early_completion_skew",
        FaultSpec(start=0.0, early_stop_skew=True),
        workload=_wl(decode_cv=0.1, rate=200.0),
        params=_pm(duration=2.5, continuous_batching=False, control="dpu",
                   dpu=DPUParams(downlink=LinkParams(delay=1e-3,
                                                     drop_p=0.5),
                                 ack_timeout=10e-3)))
    # late commands: a congested control channel delivers mitigation ~60
    # rounds after the decision — the paper's stale-feedback regime
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("late_command_actuation", "cross_replica_skew",
        FaultSpec(hot_replica=2, hot_replica_frac=0.65),
        workload=_wl(rate=300.0, duration=2.9),
        params=_pm(duration=3.0, n_replicas=4,
                   router_policy="join_shortest_queue", control="dpu",
                   dpu=DPUParams(downlink=LinkParams(delay=0.12),
                                 uplink=LinkParams(delay=2e-3))))
    # oscillating fault: fire/clear/fire in 0.35 s windows with a short
    # policy cooldown — the flap-damping (oscillation guard) regime
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    add("flapping_egress_backlog", "egress_backlog_queueing",
        FaultSpec(egress_backlog_rate=3.0, osc_period=0.35),
        params=_pm(duration=3.0, control="dpu",
                   dpu=DPUParams(cooldown=0.25, flap_window=1.5,
                                 flap_limit=2)))

    # ---------------- monitoring plane (mon table) ----------------
    # These break the watcher, not the watched: the cluster workload stays
    # healthy and the chaos knobs hit the sidecar / its links.  All three
    # run the asynchronous dpu loop.
    #
    # DPU crash at t=1.0, warm restart 0.5 s later: heartbeats stop, the
    # host watchdog fails over within silence_timeout, the standby plane's
    # outage detector confirms, and the degraded controller actuates
    # failover_controller host-side (the dead DPU obviously can't).
    add("dpu_outage", "dpu_outage",
        FaultSpec(start=1.0, dpu_crash_at=1.0, dpu_restart_after=0.5),
        params=_pm(duration=3.0, control="dpu", dpu=DPUParams(),
                   watchdog=WatchdogParams()))
    # telemetry uplink goes dark for 0.3 s: the ingest guard sees the batch
    # sequence gap when the stream resumes, latches the blackout, opens a
    # quarantine window (detectors re-warm, no actuation on stale state),
    # and the blackout row drives resync_telemetry over the healthy
    # downlink once quarantine lifts.
    add("telemetry_blackout", "telemetry_blackout",
        FaultSpec(start=1.0, uplink_blackout_start=1.0,
                  uplink_blackout_s=0.3),
        params=_pm(duration=3.0, control="dpu", dpu=DPUParams()))
    # command downlink partitions for 0.7 s: liveness pings (20 ms cadence)
    # burn their retries with zero acks, the bus latches exhaustion into
    # self-telemetry, and the watchdog's OOB read of the same counters
    # fails over so the host-side controller can actuate what the dead
    # channel cannot deliver.  The partition lifts at 1.7 and the watchdog
    # fails back after its hysteresis hold.
    add("command_partition", "command_partition",
        FaultSpec(start=1.0, downlink_partition_start=1.0,
                  downlink_partition_s=0.7),
        params=_pm(duration=3.0, control="dpu",
                   dpu=DPUParams(ping_every=0.02),
                   watchdog=WatchdogParams()))
    # hot-standby pair, standby's own uplink dark for 0.9 s: the primary
    # keeps leading (nothing cluster-facing is wrong) but the shadow's
    # detector state falls behind the tap — redundancy is silently
    # degraded, exactly the window where a primary failure would promote a
    # stale standby.  The watchdog's probe rows carry the lag; the
    # standby_lag row fires once it passes the threshold and
    # remirror_standby replays the retained window to close the gap.
    add("standby_lag", "standby_lag",
        FaultSpec(start=1.0, standby_blackout_start=1.0,
                  standby_blackout_s=0.9),
        params=_pm(duration=3.0, control="dpu", dpu=DPUParams(),
                   standby=DPUParams(), watchdog=WatchdogParams()))
    # the split-brain opener: the OOB management port partitions (heartbeat
    # reads freeze, lease renewals undeliverable) while the primary's
    # command downlink is *also* dark, so the host-side corroborating probe
    # sees no actuation either.  The primary's delivered lease horizon
    # expires, the warm standby is promoted under a new term — and then the
    # downlink heals first: the deposed primary (alive all along, lease
    # lapsed, term stale) resumes its ping stream straight into the fencing
    # registry.  Every stale-term command is rejected and recorded, zero
    # double-actuations; the OOB port heals at 1.6 and the hysteretic
    # failback re-grants the primary a fresh term.
    add("split_brain_fenced", "split_brain_fenced",
        FaultSpec(start=1.0, oob_partition_start=1.0, oob_partition_s=0.6,
                  downlink_partition_start=1.0, downlink_partition_s=0.18),
        params=_pm(duration=3.0, control="dpu",
                   dpu=DPUParams(ping_every=0.02),
                   standby=DPUParams(), watchdog=WatchdogParams()))

    # healthy baseline (false-positive budget measurement)
    s["healthy"] = Scenario(name="healthy", row_id="",
                            fault=FaultSpec(start=1e9),
                            workload=_wl(), params=_pm())
    # healthy multi-replica baseline: a sane router under the same load
    # must not trip the cross-replica detector
    # repro-lint: allow(smoke-coverage): covered by the 46-scenario golden gate and the full-registry sweep; --smoke carries one representative row per family
    s["healthy_replicated"] = Scenario(
        name="healthy_replicated", row_id="",
        fault=FaultSpec(start=1e9),
        workload=_wl(rate=300.0, duration=2.9),
        params=_pm(duration=3.0, n_replicas=4,
                   router_policy="join_shortest_queue"))
    return s


SCENARIOS: dict[str, Scenario] = make_scenarios()
