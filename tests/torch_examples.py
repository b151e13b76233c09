"""Helpers for the tests that hold ``examples/torch_*.py`` to the JAX
package's ``examples/*.py`` on the CPU: run a JAX example unchanged as a
script in a child process, beside the test's own work on the port; load an
example by its file; capture what a call prints; and make the port's model
from the weights of the JAX model's ``init(jax.random.key(0))``, which is
what the JAX examples serve and train.  Only the tests import this module
(it imports both packages)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
#: printed between two runs of one child process
SEPARATOR = "\x1e"

#: one row per runbook table (3a, 3b, 3c, 3d, 3e, dpu, mon): the drill-
#: down rows that the tests and chip_smoke.py's examples phase run
DRILL_ROWS = ("early_completion_skew", "decode_early_stop_skew",
              "tp_straggler", "hierarchical_routing_skew",
              "hbm_bandwidth_cliff", "dpu_saturation", "telemetry_blackout")


class Reference:
    """``python examples/<name>.py`` of the JAX package, unchanged, once
    for each argv, in one child process that starts at once and runs while
    the test works on the port; ``lines()`` waits for it and gives each
    run's printed lines.  With ``keep_history``, every ``repro.training.
    Trainer`` the example makes is kept, and ``histories`` holds each run's
    last one's history."""

    def __init__(self, name: str, *argvs: list[str],
                 keep_history: bool = False) -> None:
        path = str(EXAMPLES / f"{name}.py")
        code = ["import json, runpy, sys", "runs = [None]"]
        if keep_history:
            code += ["import repro.training as T",
                     "class Kept(T.Trainer):",
                     "    def __init__(self, *a, **kw):",
                     "        super().__init__(*a, **kw)",
                     "        runs[0] = self",
                     "T.Trainer = Kept"]
        code += [f"for argv in json.loads({json.dumps(json.dumps(argvs))}):",
                 f"    sys.argv = [{path!r}, *argv]",
                 f"    runpy.run_path({path!r}, run_name='__main__')",
                 "    hist = runs[0].history if runs[0] else None",
                 f"    print({SEPARATOR!r} + json.dumps(hist, default=float),"
                 " flush=True)"]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else []))}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "\n".join(code)], cwd=ROOT, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.histories: list = []

    def __enter__(self) -> "Reference":
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:      # the test failed before waiting
            self.proc.kill()
            self.proc.communicate()

    def lines(self, timeout: float = 300) -> list[list[str]]:
        out, err = self.proc.communicate(timeout=timeout)
        assert self.proc.returncode == 0, err[-3000:]
        runs, run = [], []
        # not splitlines(): it splits at the separator too
        for line in out.split("\n")[:-1]:
            if line.startswith(SEPARATOR):
                runs.append(run)
                self.histories.append(json.loads(line[len(SEPARATOR):]))
                run = []
            else:
                run.append(line)
        assert not run, run
        return runs


def load(name: str):
    """``examples/<name>.py`` as a module of its own (imported once per
    call, so a test's patches stay in its copy)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn) -> list[str]:
    """The lines ``fn()`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def bridged(arch: str):
    """The port's reduced ``arch`` on the CPU with the JAX init's weights
    (key 0)."""
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as jax_build_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import ARCHS
    params = jax_build_model(JARCHS[arch].reduced()).init(jax.random.key(0))
    return params_from_jax(ARCHS[arch].reduced(),
                           jax.tree.map(np.asarray, params), device="cpu")


def use_model(monkeypatch, example, model) -> None:
    """Make ``example.build_model`` give ``model`` for the example's own
    config on the CPU, and refuse anything else."""
    def build(cfg, device, seed=0):
        assert cfg == model.cfg and device == "cpu" and seed == 0, \
            (cfg.name, device, seed)
        return model
    monkeypatch.setattr(example, "build_model", build)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's spinning workers would oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
