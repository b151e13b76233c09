"""Run every runbook row's fault scenario on the PyTorch port and print the
full drill-down: detection, latency, attribution locus, and the paper's
mitigation directive — Tables 3(a)/(b)/(c) as a live demo, with
examples/pathology_drilldown.py's printed lines, through ``repro_torch``.

The simulator and the telemetry plane run on the host (numpy); no tensor
is made.  ``--device`` is checked as the other examples check it, so a
run that names the card fails without one.

Run:  PYTHONPATH=src python examples/torch_pathology_drilldown.py \
          [row_id] [--device cpu]
"""

import argparse

from repro_torch.core.runbooks import ALL_RUNBOOKS, BY_ID
from repro_torch.models.model import resolve_device
from repro_torch.sim import SCENARIOS, run_scenario


def drill(row_id: str) -> None:
    entry = BY_ID[row_id]
    sc = SCENARIOS[entry.scenario]
    print(f"\n=== {entry.table} — {entry.title} ===")
    print(f"signal     : {entry.signal}")
    print(f"injecting  : scenario '{entry.scenario}' "
          f"(fault starts t={sc.fault.start}s)")
    metrics, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
    hits = [f for f in plane.findings if f.name == row_id]
    if not hits:
        print("!! detector did not fire")
        return
    f = hits[0]
    print(f"detected   : t={f.ts:.2f}s severity={f.severity} "
          f"node={f.node} score={f.score:.1f}")
    if metrics.first_finding_ts > 0:
        print(f"latency    : {metrics.first_finding_ts - sc.fault.start:.2f}s "
              "after onset")
    atts = [a for a in plane.attributions if a.primary.name == row_id]
    if atts:
        print(f"attribution: {atts[0].locus} — {atts[0].narrative}")
    print(f"root cause : {entry.root_cause}")
    print(f"mitigation : {entry.mitigation}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("row_id", nargs="?",
                    help="one runbook row (default: every row)")
    ap.add_argument("--device", default="cuda",
                    help="device named for the run (cuda or cpu)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.row_id:
        drill(args.row_id)
        return
    for entry in ALL_RUNBOOKS:
        drill(entry.row_id)


if __name__ == "__main__":
    main()
