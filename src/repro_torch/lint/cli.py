"""``python -m repro_torch.lint`` — run both linter halves over the tree.

Exit codes: 0 = clean (no unsuppressed findings), 1 = findings,
2 = usage / environment error.  ``--json PATH`` additionally writes the
machine-readable report (the CI gate uploads it next to the bench
artifacts).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.lint.findings import RULES, LintReport
from repro_torch.lint.pragmas import PragmaSet, apply_pragmas, collect_pragmas
from repro_torch.lint.purity import lint_source
from repro_torch.lint.wiring import check_wiring, repo_root

#: the packages the determinism auditor walks
SCAN_PACKAGES = ("sim", "dpu", "core", "obs", "serving")


def iter_sources(root: Path):
    """Yield (repo-relative posix path, source text) for every scanned
    file, sorted for stable output."""
    base = root / "src" / "repro_torch"
    for pkg in SCAN_PACKAGES:
        for py in sorted((base / pkg).rglob("*.py")):
            yield py.relative_to(root).as_posix(), py.read_text()


def run_lint(root: Path | None = None, wiring: bool = True) -> LintReport:
    """Whole-tree run: purity pass per file, wiring pass once, pragma
    matching over both."""
    root = root or repo_root()
    findings = []
    sets: dict[str, PragmaSet] = {}
    files = 0
    for rel, source in iter_sources(root):
        files += 1
        findings.extend(lint_source(source, rel))
        sets[rel] = collect_pragmas(source, rel)
    if wiring:
        findings.extend(check_wiring(root))
    findings = apply_pragmas(findings, sets)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(findings=findings, files_scanned=files)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.lint",
        description="determinism auditor + registry-wiring checker")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the machine-readable report here")
    ap.add_argument("--root", metavar="DIR",
                    help="repo checkout root (default: inferred)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--no-wiring", action="store_true",
                    help="skip the registry-wiring pass (AST-only)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="list suppressed findings and their reasons")
    args = ap.parse_args(argv)

    if args.rules:
        for rule, desc in RULES.items():
            print(f"{rule:20s} {desc}")
        return 0

    root = Path(args.root).resolve() if args.root else repo_root()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"repro_torch.lint: {root} does not look like a checkout root "
              "(no src/repro_torch)", file=sys.stderr)
        return 2

    report = run_lint(root, wiring=not args.no_wiring)

    for f in report.unsuppressed:
        print(f.format())
    if args.show_suppressed:
        for f in report.suppressed:
            print(f.format())

    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report.to_json(), indent=2) + "\n")

    n_bad = len(report.unsuppressed)
    print(f"repro_torch.lint: {report.files_scanned} files scanned, "
          f"{n_bad} unsuppressed finding(s), "
          f"{len(report.suppressed)} suppressed", file=sys.stderr)
    return 1 if n_bad else 0
