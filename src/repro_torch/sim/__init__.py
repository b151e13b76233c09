"""Cluster simulator: pathology injection + closed-loop validation substrate."""

from repro_torch.sim.cluster import ClusterSim, FaultSpec, SimMetrics, SimParams, run_scenario
from repro_torch.sim.faults import SCENARIOS, Scenario, make_scenarios
from repro_torch.sim.sweep import SweepConfig, SweepReport, SweepResult, run_sweep
from repro_torch.sim.workload import Request, WorkloadSpec, generate

__all__ = [
    "ClusterSim", "FaultSpec", "SCENARIOS", "Scenario", "SimMetrics",
    "SimParams", "Request", "SweepConfig", "SweepReport", "SweepResult",
    "WorkloadSpec", "generate", "make_scenarios", "run_scenario",
    "run_sweep",
]
