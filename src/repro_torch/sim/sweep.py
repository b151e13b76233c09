"""Parallel scenario sweeps — the paper's study design at workstation scale.

The study characterizes skews/imbalances across *many* deployments: every
fault scenario, swept over seeds (and optionally synthesis paths), each run
carrying the full telemetry plane.  ``run_sweep`` fans the scenario registry
x seed grid across worker processes and aggregates detector findings and
sim metrics into one report:

    from repro_torch.sim.sweep import SweepConfig, run_sweep
    report = run_sweep(SweepConfig(seeds=(0, 1, 2), workers=4))
    report.summary()           # per-scenario hit rates, latencies, ev/s

CLI::

    PYTHONPATH=src python -m repro_torch.sim.sweep --seeds 0,1,2 --workers 4
    PYTHONPATH=src python -m repro_torch.sim.sweep --smoke   # CI-sized grid

Workers use the ``fork`` start method when available (the parent has
already paid the import cost; a spawn would re-import jax per worker) and
fall back to sequential execution when multiprocessing is unavailable.
Each job re-derives its scenario from the registry by name, so only small
picklable dicts cross process boundaries.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
from dataclasses import dataclass, field

from repro_torch.core.runbooks import DEFAULT_TABLES

#: the CI-sized ``--smoke`` grid: one row per family plus the routing
#: pathologies the hierarchical router owns (telemetry-borne stale view,
#: intra-replica placement skew), the three 3(e) rows (per-collective
#: straggler, rail congestion, memory-knee cliff), and the five
#: monitoring-plane chaos rows (DPU outage, telemetry blackout, command
#: partition, standby shadow lag, split-brain fencing).  Module-level so
#: ``repro_torch.lint.wiring`` can cross-reference it: every registry scenario
#: must be in this grid or carry a smoke-coverage exclusion pragma at its
#: registration site in ``sim/faults.py``.
SMOKE_SCENARIOS: tuple[str, ...] = (
    "healthy", "tp_straggler", "hot_replica",
    "stale_router_view", "hierarchical_routing_skew",
    "collective_straggler", "rail_congestion",
    "hbm_bandwidth_cliff", "dpu_outage",
    "telemetry_blackout", "command_partition",
    "standby_lag", "split_brain_fenced",
)


@dataclass(frozen=True)
class SweepJob:
    scenario: str
    seed: int
    scalar_synth: bool = False
    tables: tuple[str, ...] = DEFAULT_TABLES
    mitigate: bool = False
    trace: bool = False


@dataclass
class SweepConfig:
    scenarios: tuple[str, ...] | None = None   # None = whole registry
    seeds: tuple[int, ...] = (0,)
    workers: int = 0                           # 0 = cpu-bounded default
    scalar_synth: bool = False
    tables: tuple[str, ...] = DEFAULT_TABLES
    mitigate: bool = False
    trace: bool = False                        # attach causal tracing

    def jobs(self) -> list[SweepJob]:
        from repro_torch.sim.faults import SCENARIOS
        names = (tuple(self.scenarios) if self.scenarios is not None
                 else tuple(SCENARIOS))
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            raise ValueError(f"unknown scenarios: {unknown}")
        return [SweepJob(scenario=n, seed=s, scalar_synth=self.scalar_synth,
                         tables=self.tables, mitigate=self.mitigate,
                         trace=self.trace)
                for n in names for s in self.seeds]


@dataclass
class SweepResult:
    """One (scenario, seed) cell — plain data, picklable."""

    scenario: str
    row_id: str
    seed: int
    hit: bool                  # bound detector fired (vacuously True when
    findings: dict             # healthy); name -> count
    detect_latency: float      # first bound finding ts - fault start (s)
    events: int
    wall_s: float
    completed: int
    tokens_out: int
    p99_latency: float
    p99_ttft: float
    incidents: list = field(default_factory=list)  # incident reports
    #                        (plain dicts; only with SweepConfig.trace)

    @property
    def events_per_sec(self) -> float:
        return self.events / self.wall_s if self.wall_s > 0 else 0.0


@dataclass
class SweepReport:
    results: list[SweepResult] = field(default_factory=list)
    wall_s: float = 0.0
    workers: int = 1

    @property
    def events(self) -> int:
        return sum(r.events for r in self.results)

    def by_scenario(self) -> dict[str, list[SweepResult]]:
        out: dict[str, list[SweepResult]] = {}
        for r in self.results:
            out.setdefault(r.scenario, []).append(r)
        return out

    def hit_rate(self) -> float:
        faulted = [r for r in self.results if r.row_id]
        if not faulted:
            return 1.0
        return sum(r.hit for r in faulted) / len(faulted)

    def false_positives(self) -> int:
        """Findings on explicitly-healthy baselines."""
        return sum(sum(r.findings.values()) for r in self.results
                   if not r.row_id)

    def incident_problems(self) -> list[str]:
        """Traced-sweep gate (call only when ``SweepConfig.trace`` was
        set): every fault cell must carry exactly one schema-valid
        incident report — one trace context per fault episode — and
        every healthy cell must carry none."""
        from repro_torch.obs import validate_report
        probs: list[str] = []
        for r in self.results:
            cell = f"{r.scenario}/seed{r.seed}"
            if not r.row_id:
                if r.incidents:
                    probs.append(f"{cell}: healthy cell opened "
                                 f"{len(r.incidents)} incident(s)")
                continue
            if len(r.incidents) != 1:
                probs.append(f"{cell}: expected exactly one incident, "
                             f"got {len(r.incidents)}")
            for rep in r.incidents:
                errs = validate_report(rep)
                if errs:
                    probs.append(f"{cell}: invalid report: {errs[0]}")
        return probs

    def summary(self) -> dict:
        per_scenario = {}
        for name, rs in sorted(self.by_scenario().items()):
            lat = [r.detect_latency for r in rs if r.detect_latency >= 0]
            per_scenario[name] = {
                "runs": len(rs),
                "hit_rate": (sum(r.hit for r in rs) / len(rs)
                             if rs[0].row_id else None),
                "mean_detect_latency_s": (sum(lat) / len(lat)
                                          if lat else None),
                "findings": sum(sum(r.findings.values()) for r in rs),
                "events": sum(r.events for r in rs),
            }
        return {
            "cells": len(self.results),
            "workers": self.workers,
            "wall_s": round(self.wall_s, 3),
            "events": self.events,
            "events_per_sec": (round(self.events / self.wall_s)
                               if self.wall_s > 0 else 0),
            "hit_rate": self.hit_rate(),
            "healthy_false_positives": self.false_positives(),
            "scenarios": per_scenario,
        }


def _run_job(job: SweepJob) -> SweepResult:
    """Worker body: one scenario run with the full plane attached."""
    import dataclasses

    from repro_torch.sim.cluster import run_scenario
    from repro_torch.sim.faults import SCENARIOS

    sc = SCENARIOS[job.scenario].variant(seed=job.seed,
                                         scalar_synth=job.scalar_synth)
    params = sc.params
    if job.trace:
        params = dataclasses.replace(params, trace=True)
    # repro-lint: allow(wall-clock): harness wall-time for events/s, off the simulated path
    t0 = time.perf_counter()
    metrics, plane, sim = run_scenario(
        dataclasses.replace(sc.fault), params, sc.workload,
        mitigate=job.mitigate, tables=job.tables)
    wall = time.perf_counter() - t0  # repro-lint: allow(wall-clock): harness wall-time, see t0 above
    findings: dict[str, int] = {}
    for f in plane.findings:
        findings[f.name] = findings.get(f.name, 0) + 1
    hit = (sc.row_id in findings) if sc.row_id else True
    latency = (metrics.first_finding_ts - sc.fault.start
               if metrics.first_finding_ts >= 0 else -1.0)
    incidents = (sim.tracer.reports()
                 if getattr(sim, "tracer", None) is not None else [])
    return SweepResult(
        scenario=job.scenario, row_id=sc.row_id, seed=job.seed, hit=hit,
        findings=findings, detect_latency=latency,
        events=plane.stats.events, wall_s=wall,
        completed=metrics.completed, tokens_out=metrics.tokens_out,
        p99_latency=metrics.p(0.99), p99_ttft=metrics.p_ttft(0.99),
        incidents=incidents)


def _default_workers() -> int:
    cpus = os.cpu_count() or 1
    # leave one core for the parent on big boxes; on 1-2 core boxes the
    # sweep IS the workload, use them all
    return max(1, min(8, cpus - 1) if cpus > 2 else cpus)


def run_sweep(cfg: SweepConfig | None = None) -> SweepReport:
    """Fan the scenario x seed grid across worker processes."""
    cfg = cfg or SweepConfig()
    jobs = cfg.jobs()
    workers = cfg.workers or _default_workers()
    workers = min(workers, len(jobs)) or 1
    # repro-lint: allow(wall-clock): sweep wall-clock budget reported to the operator; cells are seed-deterministic
    t0 = time.perf_counter()
    if workers == 1:
        results = [_run_job(j) for j in jobs]
    else:
        # fork: workers inherit the already-imported tree; spawn would pay
        # a full interpreter + jax import per worker
        methods = mp.get_all_start_methods()
        ctx = mp.get_context("fork" if "fork" in methods else None)
        with ctx.Pool(processes=workers) as pool:
            results = pool.map(_run_job, jobs, chunksize=1)
    return SweepReport(results=results,
                       wall_s=time.perf_counter() - t0,  # repro-lint: allow(wall-clock): harness wall-time, see t0 above
                       workers=workers)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="parallel fault-scenario sweep with full telemetry")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario names (default: all)")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seed list (default: 0)")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes (0 = auto)")
    ap.add_argument("--scalar-synth", action="store_true",
                    help="use the per-event reference synthesis path")
    ap.add_argument("--mitigate", action="store_true",
                    help="attach the closed-loop mitigation controller")
    ap.add_argument("--trace", action="store_true",
                    help="attach causal tracing + flight recorder; "
                         "gates one schema-valid incident report per "
                         "fault cell (always on under --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized grid: one row per family, 1 seed, "
                         "2 workers")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary (and per-cell rows) to PATH")
    args = ap.parse_args(argv)

    if args.smoke:
        # smoke runs traced: the incident gate below asserts one
        # schema-valid flight-recorder report per fault cell, zero on
        # healthy — the observability layer's own CI acceptance check
        cfg = SweepConfig(
            scenarios=SMOKE_SCENARIOS,
            seeds=(0,), workers=args.workers or 2,
            scalar_synth=args.scalar_synth, mitigate=args.mitigate,
            trace=True)
    else:
        cfg = SweepConfig(
            scenarios=(tuple(args.scenarios.split(","))
                       if args.scenarios else None),
            seeds=tuple(int(s) for s in args.seeds.split(",")),
            workers=args.workers, scalar_synth=args.scalar_synth,
            mitigate=args.mitigate, trace=args.trace)
    # validate scenario names up front: a typo on the CLI should be a
    # usage error with the registry spelled out, not a traceback
    if cfg.scenarios is not None:
        from repro_torch.sim.faults import SCENARIOS
        unknown = [n for n in cfg.scenarios if n not in SCENARIOS]
        if unknown:
            print(f"sweep: unknown scenario(s): {', '.join(unknown)}\n"
                  f"registry has: {', '.join(sorted(SCENARIOS))}",
                  file=sys.stderr)
            return 2
    report = run_sweep(cfg)
    summary = report.summary()
    incident_problems: list[str] = []
    if cfg.trace:
        incident_problems = report.incident_problems()
        summary["incidents"] = sum(len(r.incidents)
                                   for r in report.results)
        summary["incident_problems"] = incident_problems
    print(json.dumps(summary, indent=2))
    if args.json:
        out_dir = os.path.dirname(args.json)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        payload = {"summary": summary,
                   "cells": [vars(r) for r in report.results]}
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
    # a sweep that misses detections, trips healthy false positives, or
    # (traced) yields malformed/missing incident reports is a regression
    # signal for CI
    ok = (report.hit_rate() == 1.0 and report.false_positives() == 0
          and not incident_problems)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
