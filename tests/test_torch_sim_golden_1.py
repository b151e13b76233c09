"""Golden fixture, shard 1 of 4: the port's cluster simulator reproduces
``tests/golden/scenario_findings.json`` exactly for every fourth registry
scenario, under columnar and under scalar (per-event) synthesis."""

import pytest

pytest.importorskip("torch")

from torch_sim_cases import check_golden, shard  # noqa: E402


@pytest.mark.parametrize("scalar", [False, True], ids=["columnar", "scalar"])
@pytest.mark.parametrize("name", shard(1))
def test_port_sim_reproduces_golden(name, scalar):
    check_golden(name, scalar)
