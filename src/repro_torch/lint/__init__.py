"""repro_torch.lint — determinism auditor + registry-wiring static analyzer.

Two halves: :mod:`repro_torch.lint.purity` walks the control-loop package ASTs
for nondeterminism (wall-clock reads, unseeded RNG, mutable defaults,
unguarded tracer/recorder hooks); :mod:`repro_torch.lint.wiring` statically
verifies the runbook registry's full detector/scenario/golden/
attribution/action chain.  Run ``python -m repro_torch.lint``; suppress with
``# repro-lint: allow(<rule>): <reason>``.
"""

from repro_torch.lint.cli import run_lint
from repro_torch.lint.findings import RULES, LintFinding, LintReport
from repro_torch.lint.purity import lint_source
from repro_torch.lint.wiring import (EXPECTED_TABLE_COUNTS, check_wiring,
                               expected_rows)

__all__ = [
    "RULES", "LintFinding", "LintReport", "run_lint", "lint_source",
    "check_wiring", "EXPECTED_TABLE_COUNTS", "expected_rows",
]
