"""Suppression pragmas: ``# repro-lint: allow(<rule>): <reason>``.

A pragma suppresses findings of exactly one rule, anchored to exactly one
statement: the pragma either trails the statement's first line or sits on a
comment line directly above it (consecutive pragma-comment lines stack, so
one statement can carry several rules).  The reason text after the second
colon is MANDATORY — an allow() with an empty reason is itself a
``bad-pragma`` finding, and a pragma that matched nothing is reported as
``unused-pragma`` so stale suppressions cannot linger.

Scope is deliberately narrow: no file-level or block-level suppressions.
Every exemption is one line away from the code it exempts, carrying the
why, which is the whole point.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.lint.findings import RULES, LintFinding

#: the pragma grammar.  Examples::
#:
#:     t0 = time.perf_counter()   # repro-lint: allow(wall-clock): harness
#:     # repro-lint: allow(smoke-coverage): nightly full sweep covers it
#:     add("egress_jitter", ...)
PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*allow\(\s*(?P<rule>[a-z0-9-]+)\s*\)\s*"
    r"(?::\s*(?P<reason>.*\S))?\s*$")

#: a comment that *looks* like a pragma attempt but fails the grammar —
#: flagged rather than silently ignored (a typo must not un-suppress code
#: without anyone noticing)
NEAR_MISS_RE = re.compile(r"#\s*repro-lint\b")


@dataclass
class Pragma:
    rule: str
    reason: str
    path: str
    line: int                    # line the pragma comment lives on
    anchor: int                  # statement line the pragma applies to
    used: bool = False


@dataclass
class PragmaSet:
    """All pragmas of one file, indexed for matching."""

    path: str
    pragmas: list[Pragma] = field(default_factory=list)
    problems: list[LintFinding] = field(default_factory=list)

    def match(self, rule: str, line: int) -> Pragma | None:
        """First unused-or-used pragma of ``rule`` anchored at ``line``."""
        for p in self.pragmas:
            if p.rule == rule and p.anchor == line:
                p.used = True
                return p
        return None

    def unused(self) -> list[LintFinding]:
        return [
            LintFinding("unused-pragma", self.path, p.line,
                        f"allow({p.rule}) matched no finding")
            for p in self.pragmas if not p.used
        ]


def collect_pragmas(source: str, path: str) -> PragmaSet:
    """Parse every pragma in ``source``; anchor own-line pragmas to the
    next non-comment, non-blank line (stacked pragma lines share it)."""
    ps = PragmaSet(path=path)
    lines = source.splitlines()
    pending: list[Pragma] = []         # own-line pragmas awaiting an anchor
    for i, raw in enumerate(lines, start=1):
        stripped = raw.strip()
        hash_pos = raw.find("#")
        comment = raw[hash_pos:] if hash_pos >= 0 else ""
        m = PRAGMA_RE.search(comment) if comment else None
        if m:
            rule, reason = m.group("rule"), m.group("reason") or ""
            if rule not in RULES:
                ps.problems.append(LintFinding(
                    "bad-pragma", path, i,
                    f"allow({rule}): unknown rule id"))
                continue
            if not reason:
                ps.problems.append(LintFinding(
                    "bad-pragma", path, i,
                    f"allow({rule}): missing reason text — every "
                    "suppression must say why"))
                continue
            p = Pragma(rule=rule, reason=reason, path=path, line=i, anchor=i)
            if stripped.startswith("#"):
                pending.append(p)      # own-line: anchors the next stmt
            else:
                ps.pragmas.append(p)   # trailing: anchors its own line
            continue
        if comment and NEAR_MISS_RE.search(comment):
            ps.problems.append(LintFinding(
                "bad-pragma", path, i,
                "malformed repro-lint pragma (expected "
                "'# repro-lint: allow(<rule>): <reason>')"))
            continue
        if stripped.startswith("#") or not stripped:
            continue                   # blank/comment: pragmas keep waiting
        for p in pending:              # first code line anchors the stack
            p.anchor = i
            ps.pragmas.append(p)
        pending.clear()
    # pragmas at EOF with no following statement anchor nothing
    for p in pending:
        ps.problems.append(LintFinding(
            "bad-pragma", path, p.line,
            f"allow({p.rule}) anchors no statement (end of file)"))
    return ps


def apply_pragmas(findings: list[LintFinding],
                  sets: dict[str, PragmaSet]) -> list[LintFinding]:
    """Mark findings suppressed in place where a pragma anchors them;
    return the combined list plus pragma-hygiene findings."""
    for f in findings:
        ps = sets.get(f.path)
        if ps is None or f.suppressed:
            continue
        p = ps.match(f.rule, f.line)
        if p is not None:
            f.suppressed = True
            f.reason = p.reason
    out = list(findings)
    for ps in sets.values():
        out.extend(ps.problems)
        out.extend(ps.unused())
    return out
