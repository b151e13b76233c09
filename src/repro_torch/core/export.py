"""Render the paper's Tables 3(a)/(b)/(c) back out of the executable
registry — documentation stays generated from the single source of truth.

  PYTHONPATH=src python -m repro_torch.core.export > RUNBOOKS.md
"""

from __future__ import annotations

from repro_torch.core.mitigation import ACTIONS
from repro_torch.core.runbooks import DEFAULT_TABLES, BY_TABLE

TITLES = {
    "3a": "Table 3(a) — North-South Runbook",
    "3b": "Table 3(b) — PCIe Observer Runbook",
    "3c": "Table 3(c) — East-West Sensing Runbook",
    "3d": "Table 3(d) — Data-Parallel Replica Runbook (extension)",
    "3e": "Table 3(e) — Collective/Rail/Memory Runbook (extension)",
    "dpu": "Table (dpu) — DPU Self-Diagnosis Runbook (extension)",
    "mon": "Table (mon) — Monitoring-Plane Outage Runbook (extension)",
}


def render_incident(report: dict) -> str:
    """Render one incident report (see ``repro_torch.obs.trace``) as a markdown
    timeline table — the human-facing face of the flight recorder.

    The table is phase-ordered causally within equal timestamps (detect
    before decide before bus before apply), and a TTM decomposition
    footer shows where the time-to-mitigate went.
    """
    ttm = report.get("ttm", {})
    ms = report.get("milestones", {})
    out = [f"## Incident {report['incident_id']} — row "
           f"`{report['row']}`" + (" (recovered)" if report.get("closed")
                                   else " (open)"), ""]
    fs = ms.get("fault_start")
    if fs is not None:
        out.append(f"Fault injected at t={fs:.3f}s; first finding at "
                   f"t={report['opened_ts']:.3f}s.")
        out.append("")
    out.append("| t (s) | phase | event | source | detail |")
    out.append("|---|---|---|---|---|")
    for ev in report.get("timeline", []):
        detail = ", ".join(f"{k}={v}" for k, v in ev["detail"].items())
        out.append(f"| {ev['ts']:.4f} | {ev['phase']} | {ev['name']} "
                   f"| {ev['source']} | {detail} |")
    phases = [(k, ttm.get(k)) for k in
              ("t_detect", "t_attribute", "t_decide", "t_bus_rtt",
               "t_apply", "t_recover")]
    if any(v is not None for _, v in phases):
        out.append("")
        out.append("TTM decomposition: " + "  ".join(
            f"{k}={v * 1000.0:.1f}ms" for k, v in phases
            if v is not None))
    return "\n".join(out) + "\n"


def render() -> str:
    out = ["# Runbooks (generated from repro_torch.core.runbooks)\n"]
    for table in DEFAULT_TABLES:
        out.append(f"\n## {TITLES[table]}\n")
        out.append("| Skew/Imbalance | Signal (Red Flag) | Lifecycle "
                   "Stages | Likely Root Cause | Mitigation Directives | "
                   "Detector | Controller Action |")
        out.append("|---|---|---|---|---|---|---|")
        for e in BY_TABLE[table]:
            out.append(
                f"| {e.title} | {e.signal} | {e.stages} | {e.root_cause} "
                f"| {e.mitigation} | `{e.detector_cls.__name__}` "
                f"| `{e.action}`: {ACTIONS[e.action]} |")
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    print(render(), end="")
