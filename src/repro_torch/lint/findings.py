"""Finding records and the rule catalog for ``repro_torch.lint``.

Every rule the linter can emit is registered here with a one-line
description; the CLI's ``--rules`` flag and the README's rule catalog both
render from this table, so a rule cannot exist without documentation.

A ``LintFinding`` is plain data: rule id, repo-relative ``path:line``
anchor, message, and — once pragma matching has run — whether it is
suppressed and by which reason.  ``python -m repro_torch.lint`` exits nonzero on
any finding with ``suppressed is False``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: rule id -> one-line description (the catalog; keep in sync with README)
RULES: dict[str, str] = {
    # -- determinism auditor (purity.py) ---------------------------------
    "wall-clock":
        "wall-clock read (time.time/perf_counter/datetime.now) outside the "
        "sampled-timing allowlist — sim results must replay bit-identically",
    "unseeded-rng":
        "module-level RNG draw (np.random.*, bare random.*) or unseeded "
        "generator construction — all draws must flow through a seeded "
        "np.random.Generator threaded from SimParams",
    "mutable-default":
        "mutable default argument ([]/{}/set()) — shared across calls, a "
        "classic cross-run state leak",
    "unguarded-hook":
        "tracer/recorder hook call not dominated by a None guard in the "
        "enclosing function — tracing must be optional at every site",
    # -- registry wiring checker (wiring.py) -----------------------------
    "wiring-counts":
        "runbook registry table counts diverge from the declared expected "
        "counts (repro_torch.lint.wiring.EXPECTED_TABLE_COUNTS)",
    "wiring-detector":
        "runbook row without a matching detector class (name/table "
        "mismatch), or a detector class no row binds",
    "wiring-scenario":
        "runbook row without a fault scenario, or a scenario naming an "
        "unknown row",
    "wiring-golden":
        "scenario without a golden fixture entry, or a stale golden entry "
        "with no scenario (tests/golden/scenario_findings.json)",
    "wiring-attribution":
        "runbook row without an attribution rule (core.attribution."
        "DIRECT_LOCUS), or a stale attribution entry",
    "wiring-action":
        "runbook row actuating through an action missing from "
        "core.mitigation.ACTIONS, an ACTIONS entry no row emits, or a "
        "policy conflict-group member unknown to ACTIONS",
    "wiring-sibling":
        "sibling_rows referencing a nonexistent row (or the row itself)",
    "smoke-coverage":
        "scenario not covered by the sweep --smoke grid and carrying no "
        "exclusion pragma, or a smoke-grid name missing from the registry",
    # -- the linter's own hygiene ----------------------------------------
    "bad-pragma":
        "malformed suppression pragma: unknown rule id or missing reason "
        "text (every suppression must say why)",
    "unused-pragma":
        "suppression pragma that matched no finding — stale suppressions "
        "hide future regressions",
}


@dataclass
class LintFinding:
    """One linter verdict, anchored to a source location."""

    rule: str
    path: str                 # repo-relative, posix separators
    line: int                 # 1-based; 0 = whole-file / registry-level
    message: str
    suppressed: bool = False
    reason: str = ""          # pragma/allowlist reason when suppressed

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = f"[{self.rule}]"
        if self.suppressed:
            return f"{loc}: {tag} suppressed ({self.reason}): {self.message}"
        return f"{loc}: {tag} {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "reason": self.reason,
        }


@dataclass
class LintReport:
    """Aggregate of one whole-tree run."""

    findings: list[LintFinding] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def unsuppressed(self) -> list[LintFinding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[LintFinding]:
        return [f for f in self.findings if f.suppressed]

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.unsuppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "unsuppressed": len(self.unsuppressed),
            "suppressed": len(self.suppressed),
            "by_rule": self.by_rule(),
            "findings": [f.to_json() for f in self.findings],
        }
