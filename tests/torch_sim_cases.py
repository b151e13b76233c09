"""Helpers for the tests that hold the PyTorch port's copy of the cluster
simulator (``repro_torch.sim``) to the golden fixture
``tests/golden/scenario_findings.json``, which the JAX package's scalar
synthesis path generated (``tests/regen_golden.py``) and which both
packages share.

The 46 registry scenarios, each under two synthesis paths, take minutes
on one CPU worker, so ``tests/test_torch_sim_golden_{0,1,2,3}.py`` each
take every fourth of them: tier-1 runs one test file per worker."""

import json
from pathlib import Path

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden"
                     / "scenario_findings.json").read_text())["scenarios"]
N_SHARDS = 4


def shard(i: int) -> list[str]:
    """The port's registry scenarios that file ``i`` of ``N_SHARDS`` runs."""
    from repro_torch.sim import SCENARIOS
    return sorted(SCENARIOS)[i::N_SHARDS]


def outcome(sc) -> dict:
    """A scenario's findings and the fixture's seven metrics, as the
    fixture records them (``tests/regen_golden.py``)."""
    from repro_torch.sim import run_scenario
    m, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
    return {
        "findings": [[f.name, f.node, f.ts, f.severity, f.score]
                     for f in plane.findings],
        "metrics": {
            "completed": m.completed,
            "tokens_out": m.tokens_out,
            "first_finding_ts": m.first_finding_ts,
            "p50_latency": m.p(0.5),
            "p99_latency": m.p(0.99),
            "p50_ttft": m.p_ttft(0.5),
            "p99_ttft": m.p_ttft(0.99),
        },
    }


def check_golden(name: str, scalar: bool) -> None:
    """The port's run of scenario ``name`` equals the fixture exactly."""
    from repro_torch.sim import SCENARIOS
    sc = SCENARIOS[name].variant(scalar_synth=scalar)
    got = outcome(sc)
    want = GOLDEN[name]
    assert sc.row_id == want["row_id"]
    assert got["findings"] == want["findings"], (
        f"{name}: findings diverge from golden")
    assert got["metrics"] == want["metrics"], (
        f"{name}: metrics diverge from golden")
