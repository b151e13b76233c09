"""Registry-wiring checker — the cross-module half of ``repro_torch.lint``.

The runbook registry is the reproduction's spine: every row must resolve,
end to end, into a detector class, ≥1 fault scenario, a golden fixture
entry, an attribution rule, a registered mitigation action (with a policy
conflict-group resolution), and — directly or by exclusion pragma — a seat
in the CI smoke sweep.  Before this module those links were held together
by naming convention plus import-time ``assert``s scattered across
``core/mitigation.py``, ``dpu/policy.py``, and hardcoded counts in
``tests/test_runbooks.py``.  They now live here, in one statically
checkable pass — and this contract is deliberately the first step of the
ROADMAP plugin-registry refactor: whatever ``@runbook_row`` decorator
registry replaces the hand-wired tables must keep :func:`check_wiring`
green, which pins the full chain while the wiring underneath it moves.

``EXPECTED_TABLE_COUNTS`` below is the single declared source for registry
size; the previously hardcoded row/table counts in ``tests/test_runbooks``
assert against it through :func:`expected_rows`.

Orphans are errors in both directions: a golden entry whose scenario is
gone, an ``ACTIONS`` key no row emits, a ``DIRECT_LOCUS`` rule for a row
that no longer exists, a detector class no row binds — each is stale
wiring that would otherwise rot silently.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from repro_torch.lint.findings import LintFinding

#: the single source of truth for registry size.  Adding a runbook row
#: means bumping the one number here — every count assertion elsewhere
#: (tests, docs) derives from this table.
EXPECTED_TABLE_COUNTS: dict[str, int] = {
    "3a": 9,       # the paper's ingress/egress rows
    "3b": 10,      # host <-> PCIe rows
    "3c": 9,       # east-west collective rows
    "3d": 2,       # data-parallel routing extensions
    "3e": 3,       # per-collective / rail / memory-knee tier
    "dpu": 1,      # the telemetry plane's self-diagnosis row
    "mon": 5,      # monitoring-plane robustness rows
}

#: scenarios with no bound runbook row — healthy baselines measure the
#: false-positive budget and are exempt from the row-chain checks
BASELINE_ROW_ID = ""

GOLDEN_REL = Path("tests") / "golden" / "scenario_findings.json"
FAULTS_REL = Path("src") / "repro_torch" / "sim" / "faults.py"


def expected_rows() -> int:
    """Total registry size implied by ``EXPECTED_TABLE_COUNTS``."""
    return sum(EXPECTED_TABLE_COUNTS.values())


def _registry_anchor(root: Path) -> tuple[str, dict[str, int]]:
    """(relpath, row_id -> line) anchors into ``core/runbooks.py`` so
    wiring findings point at the offending row, not the module."""
    rel = Path("src") / "repro_torch" / "core" / "runbooks.py"
    lines: dict[str, int] = {}
    try:
        text = (root / rel).read_text()
    except OSError:
        return rel.as_posix(), lines
    for i, line in enumerate(text.splitlines(), start=1):
        m = re.search(r'^\s*"([a-z0-9_]+)",\s*"(?:3[a-e]|dpu|mon)"', line)
        if m and m.group(1) not in lines:
            lines[m.group(1)] = i
    return rel.as_posix(), lines


def scenario_anchors(root: Path) -> tuple[str, dict[str, int]]:
    """(relpath, scenario name -> line) anchors into ``sim/faults.py`` —
    the line each scenario is registered on, which is also where a
    ``smoke-coverage`` exclusion pragma must sit."""
    lines: dict[str, int] = {}
    try:
        text = (root / FAULTS_REL).read_text()
    except OSError:
        return FAULTS_REL.as_posix(), lines
    pat = re.compile(r'(?:add\(\s*|s\[)"([a-z0-9_]+)"')
    for i, line in enumerate(text.splitlines(), start=1):
        for m in pat.finditer(line):
            lines.setdefault(m.group(1), i)
    return FAULTS_REL.as_posix(), lines


def check_wiring(root: Path | None = None) -> list[LintFinding]:
    """Statically verify the full detector/scenario/golden/attribution/
    action chain for every registry row.  Imports the registries (cheap,
    already import-time safe) but runs nothing."""
    from repro_torch.core.attribution import DIRECT_LOCUS
    from repro_torch.core.detectors import ALL_DETECTORS, Detector
    from repro_torch.core.mitigation import ACTIONS
    from repro_torch.core.runbooks import ALL_RUNBOOKS, BY_ID, BY_TABLE
    from repro_torch.dpu.policy import CONFLICT_GROUPS
    from repro_torch.sim.faults import SCENARIOS
    from repro_torch.sim.sweep import SMOKE_SCENARIOS

    root = root or repo_root()
    out: list[LintFinding] = []
    reg_path, reg_lines = _registry_anchor(root)
    sc_path, sc_lines = scenario_anchors(root)

    def row_finding(rule: str, row_id: str, msg: str) -> None:
        out.append(LintFinding(rule, reg_path, reg_lines.get(row_id, 0),
                               msg))

    # -- table counts (the one declared size) ----------------------------
    tables = {t: len(rows) for t, rows in BY_TABLE.items()}
    if set(tables) != set(EXPECTED_TABLE_COUNTS):
        out.append(LintFinding(
            "wiring-counts", reg_path, 0,
            f"registry tables {sorted(tables)} != declared "
            f"{sorted(EXPECTED_TABLE_COUNTS)}"))
    for t in sorted(set(tables) & set(EXPECTED_TABLE_COUNTS)):
        if tables[t] != EXPECTED_TABLE_COUNTS[t]:
            out.append(LintFinding(
                "wiring-counts", reg_path, 0,
                f"table {t} has {tables[t]} rows, declared "
                f"{EXPECTED_TABLE_COUNTS[t]} — update "
                "repro_torch.lint.wiring.EXPECTED_TABLE_COUNTS with the row"))
    if len(ALL_RUNBOOKS) != len(BY_ID):
        out.append(LintFinding(
            "wiring-counts", reg_path, 0,
            f"{len(ALL_RUNBOOKS) - len(BY_ID)} duplicate row_id(s) in "
            "ALL_RUNBOOKS"))

    # -- per-row chain ---------------------------------------------------
    scen_by_row: dict[str, list[str]] = {}
    for name, sc in SCENARIOS.items():
        if sc.row_id:
            scen_by_row.setdefault(sc.row_id, []).append(name)

    for e in ALL_RUNBOOKS:
        # detector class: exists, subclasses Detector, names itself
        # identically (detectors key their findings by class attrs)
        if not (isinstance(e.detector_cls, type)
                and issubclass(e.detector_cls, Detector)):
            row_finding("wiring-detector", e.row_id,
                        f"{e.row_id}: detector_cls is not a Detector "
                        "subclass")
        else:
            if getattr(e.detector_cls, "name", None) != e.row_id:
                row_finding(
                    "wiring-detector", e.row_id,
                    f"{e.row_id}: detector {e.detector_cls.__name__}.name "
                    f"is {getattr(e.detector_cls, 'name', None)!r}")
            if getattr(e.detector_cls, "table", None) != e.table:
                row_finding(
                    "wiring-detector", e.row_id,
                    f"{e.row_id}: detector {e.detector_cls.__name__}.table "
                    f"is {getattr(e.detector_cls, 'table', None)!r}, row "
                    f"says {e.table!r}")
            if e.detector_cls not in ALL_DETECTORS:
                row_finding(
                    "wiring-detector", e.row_id,
                    f"{e.row_id}: {e.detector_cls.__name__} missing from "
                    "detectors.ALL_DETECTORS")
        # scenario chain: the canonical scenario exists, points back, and
        # the row has >= 1 scenario overall
        if e.scenario not in SCENARIOS:
            row_finding("wiring-scenario", e.row_id,
                        f"{e.row_id}: scenario {e.scenario!r} not in "
                        "sim.faults.SCENARIOS")
        elif SCENARIOS[e.scenario].row_id != e.row_id:
            row_finding(
                "wiring-scenario", e.row_id,
                f"{e.row_id}: scenario {e.scenario!r} validates "
                f"{SCENARIOS[e.scenario].row_id!r}, not this row")
        if not scen_by_row.get(e.row_id):
            row_finding("wiring-scenario", e.row_id,
                        f"{e.row_id}: no scenario validates this row")
        # attribution rule
        if e.row_id not in DIRECT_LOCUS:
            row_finding("wiring-attribution", e.row_id,
                        f"{e.row_id}: no attribution.DIRECT_LOCUS entry")
        # action registered + conflict-group resolvable (an action absent
        # from CONFLICT_GROUPS arbitrates as its own singleton group,
        # which is a valid resolution — membership is only checked for
        # consistency below)
        if e.action not in ACTIONS:
            row_finding("wiring-action", e.row_id,
                        f"{e.row_id}: action {e.action!r} not registered "
                        "in mitigation.ACTIONS")
        # siblings are real, distinct rows
        for sib in e.sibling_rows:
            if sib == e.row_id:
                row_finding("wiring-sibling", e.row_id,
                            f"{e.row_id}: lists itself as a sibling")
            elif sib not in BY_ID:
                row_finding("wiring-sibling", e.row_id,
                            f"{e.row_id}: sibling {sib!r} is not a "
                            "registry row")

    # -- orphans (stale wiring, reverse direction) -----------------------
    bound_detectors = {e.detector_cls for e in ALL_RUNBOOKS}
    for cls in ALL_DETECTORS:
        if cls not in bound_detectors:
            out.append(LintFinding(
                "wiring-detector", reg_path, 0,
                f"detector {cls.__name__} ({getattr(cls, 'name', '?')}) "
                "is bound to no runbook row"))
    for name, sc in SCENARIOS.items():
        if sc.row_id and sc.row_id not in BY_ID:
            out.append(LintFinding(
                "wiring-scenario", sc_path, sc_lines.get(name, 0),
                f"scenario {name!r} validates unknown row "
                f"{sc.row_id!r}"))
    emitted = {e.action for e in ALL_RUNBOOKS}
    for action in sorted(set(ACTIONS) - emitted):
        out.append(LintFinding(
            "wiring-action", "src/repro_torch/core/mitigation.py", 0,
            f"ACTIONS[{action!r}] is emitted by no runbook row — stale "
            "actuation surface"))
    for action in sorted(set(CONFLICT_GROUPS) - set(ACTIONS)):
        out.append(LintFinding(
            "wiring-action", "src/repro_torch/dpu/policy.py", 0,
            f"CONFLICT_GROUPS[{action!r}] references an action missing "
            "from mitigation.ACTIONS"))
    for row_id in sorted(set(DIRECT_LOCUS) - set(BY_ID)):
        out.append(LintFinding(
            "wiring-attribution", "src/repro_torch/core/attribution.py", 0,
            f"DIRECT_LOCUS[{row_id!r}] names a row that is not in the "
            "registry"))

    # -- golden fixtures -------------------------------------------------
    out.extend(_check_goldens(root, SCENARIOS))

    # -- smoke-grid coverage ---------------------------------------------
    for name in SMOKE_SCENARIOS:
        if name not in SCENARIOS:
            out.append(LintFinding(
                "smoke-coverage", "src/repro_torch/sim/sweep.py", 0,
                f"--smoke grid names unknown scenario {name!r}"))
    smoke = set(SMOKE_SCENARIOS)
    for name in SCENARIOS:
        if name in smoke:
            continue
        out.append(LintFinding(
            "smoke-coverage", sc_path, sc_lines.get(name, 0),
            f"scenario {name!r} is not in the sweep --smoke grid; add it "
            "or carry an explicit exclusion pragma naming the gate that "
            "does cover it"))
    return out


def _check_goldens(root: Path, scenarios: dict) -> list[LintFinding]:
    out: list[LintFinding] = []
    gpath = (root / GOLDEN_REL)
    rel = GOLDEN_REL.as_posix()
    try:
        payload = json.loads(gpath.read_text())
    except (OSError, ValueError) as e:
        return [LintFinding("wiring-golden", rel, 0,
                            f"cannot load golden fixtures: {e}")]
    golden = payload.get("scenarios", {})
    sc_path, sc_lines = scenario_anchors(root)
    for name, sc in scenarios.items():
        entry = golden.get(name)
        if entry is None:
            out.append(LintFinding(
                "wiring-golden", sc_path, sc_lines.get(name, 0),
                f"scenario {name!r} has no golden fixture entry — run "
                "tests/regen_golden.py"))
        elif entry.get("row_id", "") != sc.row_id:
            out.append(LintFinding(
                "wiring-golden", rel, 0,
                f"golden entry {name!r} pins row "
                f"{entry.get('row_id')!r}, registry says {sc.row_id!r}"))
    for name in golden:
        if name not in scenarios:
            out.append(LintFinding(
                "wiring-golden", rel, 0,
                f"stale golden entry {name!r}: no such scenario in the "
                "registry"))
    return out


def repo_root() -> Path:
    """The checkout root (…/src/repro_torch/lint/wiring.py -> three up)."""
    return Path(__file__).resolve().parents[3]
