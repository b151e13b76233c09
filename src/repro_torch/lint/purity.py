"""Determinism auditor — the AST half of ``repro_torch.lint``.

Walks the control-loop packages (``sim``, ``dpu``, ``core``, ``obs``,
``serving``) and flags the four classes of nondeterminism that have
historically surfaced as mysterious golden churn PRs later:

``wall-clock``
    Calls to ``time.time`` / ``time.perf_counter`` / ``datetime.now`` and
    friends.  Sim results must replay bit-identically from a seed; a wall
    clock on any simulated path breaks that silently.  The sampled-timing
    sites in ``core/telemetry.py`` (the overhead measurement the
    benchmarks report — deliberately wall-clock, deliberately off the
    result path) are exempted by the ``WALL_CLOCK_ALLOWLIST`` below; each
    entry carries its reason and surfaces in the report as a *suppressed*
    finding, so the exemption inventory is as auditable as a pragma.

``unseeded-rng``
    Module-level RNG draws (``np.random.rand`` etc., bare ``random.*``)
    and unseeded generator constructions (``np.random.default_rng()`` /
    ``random.Random()`` with no arguments).  Every draw must flow through
    a seeded ``np.random.Generator`` threaded from ``SimParams`` — the
    invariant that keeps "zero RNG drawn when knobs are off" checkable at
    all.  ``jax.random`` is exempt by construction (functional, key-based).

``mutable-default``
    Mutable default arguments — shared across calls, the classic
    cross-run state leak.

``unguarded-hook``
    A call through a ``.tracer`` / ``.recorder`` attribute (or a local
    alias of one) that is not dominated by a ``None`` guard within the
    enclosing function — the PR-9 invariant ("every hook site
    None-guarded") checked by a small dominator walk over the function
    body rather than by convention.  Recognized guard shapes::

        if self.tracer is not None: self.tracer.on_x(...)
        if self.tracer is None: return          # early-out dominator
        t = self.tracer
        if t: t.on_x(...)                       # alias + truthiness
        x = a.tracer.reports() if a.tracer is not None else []
        tracer is not None and tracer.on_x(...)

    ``getattr(obj, "tracer", None)`` normalizes to ``obj.tracer`` so
    defensive lookups guard the same key.
"""

from __future__ import annotations

import ast

from repro_torch.lint.findings import LintFinding

#: wall-clock reads; anything else on these modules is fine (time.sleep
#: never appears on a simulated path, and flagging sleeps is out of scope)
WALL_CLOCK_FNS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
    "clock", "now", "utcnow", "today",
}

#: np.random constructors that are fine WHEN GIVEN a seed argument
SEEDED_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "MT19937", "SFC64", "RandomState"}

#: (repo-relative path, function qualname) -> reason.  The only legal home
#: for wall-clock reads on the telemetry path: the sampled overhead-timing
#: windows whose whole job is to measure real elapsed time.  These surface
#: as suppressed findings (with these reasons) in every report.
WALL_CLOCK_ALLOWLIST: dict[tuple[str, str], str] = {
    ("src/repro_torch/core/telemetry.py", "DPUAgent._update_timed"):
        "sampled per-detector overhead timing — measures wall time by "
        "design, off the result path",
    ("src/repro_torch/core/telemetry.py", "DPUAgent.observe"):
        "sampled (every-Nth-event) ingest overhead timing window",
    ("src/repro_torch/core/telemetry.py", "DPUAgent.observe_batch"):
        "sampled (every-Nth-batch) ingest overhead timing window",
    ("src/repro_torch/core/telemetry.py", "DPUAgent.poll"):
        "detector poll overhead accounting (TelemetryStats.poll_seconds)",
}

#: attribute names whose holders are observability hooks: any call routed
#: through one of these must be None-guarded (tracing is always optional)
HOOK_ATTRS = ("tracer", "recorder")


# ---------------------------------------------------------------------------
# expression normalization


def _normalize(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted-path rendering of an expression, resolving local aliases and
    ``getattr(x, "y", ...)`` to ``x.y``.  None for anything non-trivial."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        base = _normalize(node.value, aliases)
        return None if base is None else f"{base}.{node.attr}"
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "getattr" and len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)):
        base = _normalize(node.args[0], aliases)
        return None if base is None else f"{base}.{node.args[1].value}"
    return None


def _guard_covers(key: str, guarded: frozenset) -> bool:
    """Is ``key`` (a call receiver) dominated by a guard?  A guard on the
    hook holder itself covers deeper attribute access — once ``tracer``
    is known non-None, ``tracer.counters.get(...)`` is safe; the rule
    only polices the holder being None."""
    if key in guarded:
        return True
    parts = key.split(".")
    for i in range(1, len(parts)):
        if parts[i - 1] in HOOK_ATTRS and ".".join(parts[:i]) in guarded:
            return True
    return False


def _is_hook_expr(path: str | None) -> bool:
    """Does this dotted path route through a hook holder attribute?"""
    if path is None:
        return False
    parts = path.split(".")
    # the final segment is the method being called; any earlier segment
    # being a hook attr means the receiver is (reached through) a hook
    return any(p in HOOK_ATTRS for p in parts[:-1]) or (
        len(parts) >= 2 and parts[-2] in HOOK_ATTRS)


# ---------------------------------------------------------------------------
# guard extraction (the dominator walk's transfer functions)


def _guards_from_test(test: ast.expr, aliases: dict[str, str],
                      ) -> tuple[set[str], set[str]]:
    """(non_none_if_true, non_none_if_false) keys established by a test.

    ``x is not None`` / bare truthiness guard the true branch;
    ``x is None`` / ``not x`` guard the false branch; ``and`` chains
    accumulate conjunct guards on the true side.
    """
    true_set: set[str] = set()
    false_set: set[str] = set()
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left = _normalize(test.left, aliases)
        right = test.comparators[0]
        is_none = isinstance(right, ast.Constant) and right.value is None
        if left is not None and is_none:
            if isinstance(test.ops[0], ast.IsNot):
                true_set.add(left)
            elif isinstance(test.ops[0], ast.Is):
                false_set.add(left)
        return true_set, false_set
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        t, f = _guards_from_test(test.operand, aliases)
        return f, t
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            t, _ = _guards_from_test(v, aliases)
            true_set |= t
        return true_set, set()
    key = _normalize(test, aliases)
    if key is not None:               # bare truthiness: `if self.tracer:`
        true_set.add(key)
    return true_set, set()


def _terminates(body: list[ast.stmt]) -> bool:
    """Does this block unconditionally leave the enclosing scope/loop?"""
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


class _FunctionAuditor:
    """Per-function unguarded-hook analysis: a linear dominator walk that
    threads the set of known-non-None hook keys through the statement
    list, branching at ifs and re-joining after early-out guards."""

    def __init__(self, checker: "PurityChecker", qualname: str) -> None:
        self.checker = checker
        self.qualname = qualname
        self.aliases: dict[str, str] = {}

    def run(self, fn: ast.AST) -> None:
        self._collect_aliases(fn)
        self._walk_block(fn.body, frozenset())

    def _collect_aliases(self, fn: ast.AST) -> None:
        """``t = self.tracer``-style bindings, function-wide.  A name
        rebound to two different hook paths is dropped (ambiguous)."""
        dropped: set[str] = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                name = node.targets[0].id
                path = _normalize(node.value, {})
                if path is not None and _is_hook_expr(f"{path}._"):
                    if name in self.aliases and self.aliases[name] != path:
                        dropped.add(name)
                    self.aliases[name] = path
        for name in dropped:
            self.aliases.pop(name, None)

    # -- statements ------------------------------------------------------

    def _walk_block(self, body: list[ast.stmt],
                    guarded: frozenset) -> frozenset:
        for stmt in body:
            guarded = self._walk_stmt(stmt, guarded)
        return guarded

    def _walk_stmt(self, stmt: ast.stmt, guarded: frozenset) -> frozenset:
        if isinstance(stmt, ast.If):
            t, f = _guards_from_test(stmt.test, self.aliases)
            self._check_expr(stmt.test, guarded)
            self._walk_block(stmt.body, guarded | t)
            self._walk_block(stmt.orelse, guarded | f)
            # early-out dominator: `if x is None: return` guards the rest
            if f and not stmt.orelse and _terminates(stmt.body):
                guarded = guarded | f
            return guarded
        if isinstance(stmt, ast.While):
            t, _ = _guards_from_test(stmt.test, self.aliases)
            self._check_expr(stmt.test, guarded)
            self._walk_block(stmt.body, guarded | t)
            self._walk_block(stmt.orelse, guarded)
            return guarded
        if isinstance(stmt, ast.For):
            self._check_expr(stmt.iter, guarded)
            self._walk_block(stmt.body, guarded)
            self._walk_block(stmt.orelse, guarded)
            return guarded
        if isinstance(stmt, ast.Try):
            self._walk_block(stmt.body, guarded)
            for h in stmt.handlers:
                self._walk_block(h.body, guarded)
            self._walk_block(stmt.orelse, guarded)
            self._walk_block(stmt.finalbody, guarded)
            return guarded
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._check_expr(item.context_expr, guarded)
            self._walk_block(stmt.body, guarded)
            return guarded
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return guarded            # nested defs audited on their own
        if isinstance(stmt, ast.Assert):
            # `assert x is not None` dominates everything after it
            t, _ = _guards_from_test(stmt.test, self.aliases)
            return guarded | t
        if isinstance(stmt, ast.Assign):
            # assigning a hook key kills its guard (it may now be None)
            self._check_expr(stmt.value, guarded)
            killed = {
                _normalize(t, self.aliases)
                for t in stmt.targets
            } - {None}
            return frozenset(k for k in guarded if k not in killed)
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._check_expr(node, guarded)
        return guarded

    # -- expressions -----------------------------------------------------

    def _check_expr(self, expr: ast.expr, guarded: frozenset) -> None:
        if isinstance(expr, ast.IfExp):
            t, f = _guards_from_test(expr.test, self.aliases)
            self._check_expr(expr.test, guarded)
            self._check_expr(expr.body, guarded | t)
            self._check_expr(expr.orelse, guarded | f)
            return
        if isinstance(expr, ast.BoolOp):
            acc = frozenset(guarded)
            for v in expr.values:
                self._check_expr(v, acc)
                if isinstance(expr.op, ast.And):
                    t, _ = _guards_from_test(v, self.aliases)
                    acc = acc | t
            return
        if isinstance(expr, ast.Call):
            path = _normalize(expr.func, self.aliases)
            if _is_hook_expr(path):
                key = path.rsplit(".", 1)[0]
                if not _guard_covers(key, guarded):
                    self.checker._hook_finding(expr, path, self.qualname)
            self._check_expr(expr.func, guarded)
            for a in expr.args:
                self._check_expr(a, guarded)
            for kw in expr.keywords:
                self._check_expr(kw.value, guarded)
            return
        if isinstance(expr, (ast.FunctionDef, ast.Lambda)):
            return
        for node in ast.iter_child_nodes(expr):
            if isinstance(node, ast.expr):
                self._check_expr(node, guarded)


# ---------------------------------------------------------------------------
# the file-level pass


class PurityChecker(ast.NodeVisitor):
    """One file's determinism audit; collect with :func:`lint_source`."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.findings: list[LintFinding] = []
        self._qual: list[str] = []      # class/function nesting stack
        # module-alias tracking: local name -> canonical module
        self._modules: dict[str, str] = {}
        # names imported from modules: local name -> "module.attr"
        self._from_imports: dict[str, str] = {}

    # -- imports ---------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self._modules[a.asname or a.name.split(".")[0]] = a.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is not None and not node.level:
            for a in node.names:
                self._from_imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
        self.generic_visit(node)

    # -- scoping ---------------------------------------------------------

    @property
    def qualname(self) -> str:
        return ".".join(self._qual) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def _visit_function(self, node) -> None:
        self._check_defaults(node)
        self._qual.append(node.name)
        # the hook dominator walk runs per function body
        _FunctionAuditor(self, self.qualname).run(node)
        self.generic_visit(node)
        self._qual.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- mutable defaults ------------------------------------------------

    def _check_defaults(self, node) -> None:
        args = node.args
        for default in (*args.defaults, *args.kw_defaults):
            if default is None:
                continue
            bad = None
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                bad = {ast.List: "[]", ast.Dict: "{}",
                       ast.Set: "{...}"}[type(default)]
            elif (isinstance(default, ast.Call)
                    and isinstance(default.func, ast.Name)
                    and default.func.id in ("list", "dict", "set",
                                            "bytearray")):
                bad = f"{default.func.id}()"
            if bad is not None:
                self.findings.append(LintFinding(
                    "mutable-default", self.path, default.lineno,
                    f"mutable default {bad} on {node.name}() — shared "
                    "across calls; use None + in-body construction (or "
                    "dataclasses.field(default_factory=...))"))

    # -- calls: wall clock + rng -----------------------------------------

    def _canonical_call(self, func: ast.expr) -> str | None:
        """Render a call target as 'module.attr[.attr]' in canonical
        module names, resolving import aliases; None if untraceable."""
        if isinstance(func, ast.Name):
            return self._from_imports.get(func.id)
        if isinstance(func, ast.Attribute):
            parts = [func.attr]
            cur = func.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if not isinstance(cur, ast.Name):
                return None
            root = cur.id
            if root in self._modules:
                parts.append(self._modules[root])
            elif root in self._from_imports:
                parts.append(self._from_imports[root])
            else:
                return None
            return ".".join(reversed(parts))
        return None

    def visit_Call(self, node: ast.Call) -> None:
        target = self._canonical_call(node.func)
        if target is not None:
            self._check_wall_clock(node, target)
            self._check_rng(node, target)
        self.generic_visit(node)

    def _check_wall_clock(self, node: ast.Call, target: str) -> None:
        mod, _, fn = target.rpartition(".")
        is_clock = (
            (mod == "time" and fn in WALL_CLOCK_FNS)
            or (mod in ("datetime", "datetime.datetime", "datetime.date")
                and fn in ("now", "utcnow", "today"))
        )
        if not is_clock:
            return
        allow = WALL_CLOCK_ALLOWLIST.get((self.path, self.qualname))
        self.findings.append(LintFinding(
            "wall-clock", self.path, node.lineno,
            f"{target}() in {self.qualname} — wall-clock reads break "
            "seeded replay; thread sim time in instead",
            suppressed=allow is not None,
            reason=allow or ""))

    def _check_rng(self, node: ast.Call, target: str) -> None:
        parts = target.split(".")
        # numpy module-level RNG: numpy.random.<fn>(...)
        if len(parts) >= 3 and parts[0] == "numpy" and parts[1] == "random":
            fn = parts[2]
            if fn not in SEEDED_CTORS:
                self.findings.append(LintFinding(
                    "unseeded-rng", self.path, node.lineno,
                    f"module-level np.random.{fn}() in {self.qualname} — "
                    "draws from global state; use the seeded "
                    "np.random.Generator threaded from SimParams"))
            elif fn == "default_rng" and not node.args and not node.keywords:
                self.findings.append(LintFinding(
                    "unseeded-rng", self.path, node.lineno,
                    f"np.random.default_rng() without a seed in "
                    f"{self.qualname} — entropy-seeded; thread the seed "
                    "from SimParams"))
            return
        # stdlib random: bare module functions, or Random() without seed
        if parts[0] == "random" and len(parts) >= 2:
            fn = parts[1]
            if fn == "Random":
                if not node.args and not node.keywords:
                    self.findings.append(LintFinding(
                        "unseeded-rng", self.path, node.lineno,
                        f"random.Random() without a seed in "
                        f"{self.qualname}"))
            elif fn[:1].islower():
                self.findings.append(LintFinding(
                    "unseeded-rng", self.path, node.lineno,
                    f"bare random.{fn}() in {self.qualname} — global-state "
                    "draw; use a seeded np.random.Generator"))

    # -- hook findings (reported by the dominator walk) ------------------

    def _hook_finding(self, node: ast.Call, path: str,
                      qualname: str) -> None:
        recv, _, meth = path.rpartition(".")
        self.findings.append(LintFinding(
            "unguarded-hook", self.path, node.lineno,
            f"{recv}.{meth}() in {qualname} not dominated by a None "
            f"guard on '{recv}' — hook holders default to None and every "
            "call site must tolerate that"))


def lint_source(source: str, path: str) -> list[LintFinding]:
    """Audit one file's source text (the unit-test entry point)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:                       # pragma: no cover
        return [LintFinding("wall-clock", path, e.lineno or 0,
                            f"unparseable file: {e.msg}")]
    checker = PurityChecker(path)
    checker.visit(tree)
    return checker.findings
