"""On the card: each cell's check passes the program and fails the
control (the float32 reference with float8 weights in the program's
place), at the cell's own sizes with a short window.  Skips without a
card.  Run on the card with:

    PYTHONPATH=src python3 -m pytest -q -m card bench/test_bench_card.py
"""

import json

import pytest
import torch

from bench.cell import ROOT, load
from bench.check import judge
from bench.control import readings

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = load(workload)
    out = readings(cell, 7_000_001, 8.0, torch.device("cuda", 0), True)
    assert judge(out["program"], cell.limits)[0], out["program"]
    assert not judge(out["control"], cell.limits)[0], out["control"]
