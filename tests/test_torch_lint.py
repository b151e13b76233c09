"""The JAX package's determinism auditor (``repro.lint.purity``) over the
port's control-plane code: each file of ``repro_torch`` in ``core/``,
``dpu/``, ``obs/`` and ``serving/`` is audited under the path of its
counterpart in ``repro``, so the wall-clock allowlist (the sampled timing
windows of ``core/telemetry.py``) applies to it as to the original.  A copy
gives exactly its original's findings; the port's engine, the one module
that is not a copy, gives none that is not suppressed.

The port's own linter (``repro_torch.lint``, a copy pointed at
``src/repro_torch``) audits the same tree with its wiring pass as well: it
must be clean, and outside the engine its findings must be the reference
linter's on ``src/repro`` once the path prefix is mapped."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.lint.pragmas import apply_pragmas, collect_pragmas
from repro.lint.purity import lint_source

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(p.relative_to(PORT).as_posix()
               for pkg in ("core", "dpu", "obs", "serving")
               for p in (PORT / pkg).glob("*.py"))
NOT_COPIES = ("serving/engine.py",)


def _audit(source: str, path: str) -> list[tuple]:
    found = apply_pragmas(lint_source(source, path),
                          {path: collect_pragmas(source, path)})
    return [(f.rule, f.line, f.message, f.suppressed, f.reason)
            for f in found]


@pytest.mark.parametrize("name", FILES)
def test_port_file_audits_like_its_reference(name):
    ref = f"src/repro/{name}"
    port = _audit((PORT / name).read_text(), ref)
    if name in NOT_COPIES:
        assert [f for f in port if not f[3]] == []
    else:
        assert port == _audit((ROOT / ref).read_text(), ref)


def test_the_audit_sees_the_control_plane():
    assert {"core/telemetry.py", "dpu/sidecar.py", "dpu/watchdog.py",
            "obs/trace.py", "serving/router.py",
            "serving/engine.py"} <= set(FILES)
    # the allowlisted timing windows surface, suppressed, in the copy
    found = _audit((PORT / "core/telemetry.py").read_text(),
                   "src/repro/core/telemetry.py")
    assert found and all(f[0] == "wall-clock" and f[3] for f in found)


def _report(pkg: str) -> tuple[int, list[tuple]]:
    report = importlib.import_module(f"{pkg}.lint").run_lint(ROOT)
    prefix = f"src/{pkg}/"
    rows = [(f.path.removeprefix(prefix), f.rule, f.line, f.message,
             f.suppressed, f.reason) for f in report.findings]
    return report.files_scanned, rows


def test_port_linter_is_clean():
    files, rows = _report("repro_torch")
    assert files == 31
    assert [r for r in rows if not r[4]] == []
    # the allowlisted timing windows of core/telemetry.py surface suppressed
    assert any(r[0] == "core/telemetry.py" and r[1] == "wall-clock" and r[4]
               for r in rows)


def test_port_linter_finds_what_the_reference_linter_finds():
    (ref_files, ref), (port_files, port) = (_report(p) for p in
                                            ("repro", "repro_torch"))
    assert port_files == ref_files
    assert ([r for r in port if r[0] not in NOT_COPIES]
            == [r for r in ref if r[0] not in NOT_COPIES])
    assert len(port) > 40


def test_python_m_repro_torch_lint_exits_0(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run([sys.executable, "-m", "repro_torch.lint"],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "31 files scanned, 0 unsuppressed" in done.stderr
