"""Golden fixture, shard 0 of 4: the port's cluster simulator reproduces
``tests/golden/scenario_findings.json`` exactly for every fourth registry
scenario, under columnar and under scalar (per-event) synthesis."""

import pytest

pytest.importorskip("torch")

from torch_sim_cases import check_golden, shard  # noqa: E402


@pytest.mark.parametrize("scalar", [False, True], ids=["columnar", "scalar"])
@pytest.mark.parametrize("name", shard(0))
def test_port_sim_reproduces_golden(name, scalar):
    check_golden(name, scalar)


def test_port_registry_names_the_fixture_scenarios():
    from repro_torch.sim import SCENARIOS
    from torch_sim_cases import GOLDEN
    assert len(GOLDEN) == 46
    assert sorted(SCENARIOS) == sorted(GOLDEN)
    assert {n: SCENARIOS[n].row_id for n in SCENARIOS} == {
        n: g["row_id"] for n, g in GOLDEN.items()}
