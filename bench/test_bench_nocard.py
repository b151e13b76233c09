"""Without a CUDA card, a measurement run exits with an error and prints
no numbers."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a host without one")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "zamba2-7b.long_prompt", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_unknown_workload_fails():
    sys.path.insert(0, str(ROOT))
    from bench.cell import load
    with pytest.raises(SystemExit):
        load("no-such-cell")
