"""The port's copy of the cluster simulator (``repro_torch.sim``) against
the JAX package's: the same scenarios give the same event batches, the
same sweep summaries and the same findings, attributions, actions and
metrics, compared with ``==`` through ``tests/torch_parity.py``.  Both
sides run numpy only, so equality is exact."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import PACKAGES, batch_columns, package, plain  # noqa: E402

#: the scenarios of the reference's own synthesis-parity test
#: (``tests/test_sim_columnar.py::TestSynthesisParity``)
TRACE_CASES = ("healthy", "burst_admission", "egress_jitter",
               "registration_churn", "hot_replica")
#: summary keys read off the host's clock
WALL_CLOCK = ("wall_s", "events_per_sec")


def _sim(pkg: str):
    return package(pkg, "sim", "sim.cluster", "sim.sweep", "core.events")


def _batches(pkg: str, name: str, scalar: bool) -> list[dict]:
    S = _sim(pkg)
    sc = S.SCENARIOS[name].variant(scalar_synth=scalar)
    wl = dataclasses.replace(sc.workload, duration=sc.params.duration * 0.98)
    rec = S.EventTraceRecorder()
    S.ClusterSim(sc.params, wl, sc.fault, plane=rec).run()
    return [batch_columns(b) for b in rec.batches]


@pytest.mark.parametrize("name", TRACE_CASES)
def test_event_batches_equal_the_reference(name):
    ref, port = (_batches(p, name, scalar=False) for p in PACKAGES)
    assert len(port) == len(ref) > 0
    assert port == ref


@pytest.mark.parametrize("name", TRACE_CASES)
def test_columnar_and_scalar_synthesis_are_bit_identical(name):
    S = _sim("repro_torch")
    vec, sca = (_batches("repro_torch", name, s) for s in (False, True))
    assert len(vec) == len(sca) > 0
    for x, y in zip(vec, sca):
        for col in S.BATCH_COLUMNS:
            assert np.array_equal(x[col], y[col]), (name, col)


def _sweep(pkg: str, workers: int):
    S = _sim(pkg)
    report = S.run_sweep(S.SweepConfig(scenarios=("healthy", "tp_straggler"),
                                       seeds=(0,), workers=workers,
                                       trace=True))
    summary = {k: v for k, v in report.summary().items()
               if k not in WALL_CLOCK}
    cells = [{k: v for k, v in vars(r).items() if k not in WALL_CLOCK}
             for r in report.results]
    return summary, plain(cells), report.incident_problems()


@pytest.mark.parametrize("workers", [1, 2])
def test_sweep_summary_equals_the_reference(workers):
    ref, port = (_sweep(p, workers) for p in PACKAGES)
    assert port == ref
    summary, _, problems = port
    assert summary["hit_rate"] == 1.0 and summary["workers"] == workers
    assert summary["healthy_false_positives"] == 0 and problems == []


def test_sweep_cli_exit_codes(capsys):
    from repro_torch.sim.sweep import main
    assert main(["--scenarios", "healthy,tp_straggler", "--workers", "1"]) == 0
    assert '"hit_rate": 1.0' in capsys.readouterr().out
    assert main(["--scenarios", "healthy,no_such_scenario"]) == 2
    assert "no_such_scenario" in capsys.readouterr().err


def _quickstart(pkg: str) -> dict:
    """Steps 3 and 4 of ``examples/quickstart.py`` on one package."""
    S = _sim(pkg)
    sc = S.SCENARIOS["tp_straggler"]
    m, plane, _ = S.run_scenario(sc.fault, sc.params, sc.workload)
    out = {"tp_straggler": plain({
        "findings": plane.findings, "attributions": plane.attributions,
        "actions": plane.actions, "metrics": m})}
    sc = S.SCENARIOS["hot_replica"]
    for mitigate in (False, True):
        m, plane, _ = S.run_scenario(dataclasses.replace(sc.fault),
                                     sc.params, sc.workload,
                                     mitigate=mitigate)
        out[f"hot_replica/{mitigate}"] = plain({
            "findings": plane.findings, "attributions": plane.attributions,
            "actions": plane.actions, "metrics": m})
    return out


def test_quickstart_pathologies_equal_the_reference():
    ref, port = (_quickstart(p) for p in PACKAGES)
    assert port == ref
    straggler = port["tp_straggler"]
    assert any(f[1]["name"] == "tp_straggler"
               for f in straggler["findings"])
    off, on = port["hot_replica/False"], port["hot_replica/True"]
    assert on["actions"] and not off["actions"]
