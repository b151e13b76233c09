"""Tiny cells for the CPU tests: each family at a few layers of small
width, the kernels' plain versions, a closed loop of four clients.  Each
configuration names its reference module as the full ones do."""

from __future__ import annotations

import dataclasses

TINY_MIX = {
    "clients": 4, "slots": 4, "max_seq": 160, "step_time": 0.002,
    "prompt": {"min": 20, "max": 128, "median": 60, "sigma": 0.5},
    "output": {"min": 2, "max": 8, "median": 4, "sigma": 0.4},
    "deck": 64, "warmup_iters": 3, "trace_iters": 3,
    "check": {"min_requests": 3, "min_tokens": 20, "max_requests": 6},
}
DT_INIT = {"min": 1e-3, "max": 0.1, "floor": 1e-4}
REFERENCE = {"hybrid": "bench/reference/hybrid.py",
             "moe": "bench/reference/moe.py"}


def run_sizes(family: str, dtype: str = "float32") -> dict:
    from repro_torch.configs.registry import get
    if family == "hybrid":
        cfg = dataclasses.replace(get("zamba2-7b").reduced(), n_layers=5)
    else:
        cfg = dataclasses.replace(get("qwen2-moe-a2.7b").reduced(),
                                  capacity_factor=1.25)
    return dataclasses.asdict(dataclasses.replace(cfg, dtype=dtype,
                                                  vocab=512))


def cell(family: str, limits=None, dtype: str = "float32", **mix):
    import json

    from bench.cell import ROOT, Cell, reference
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = {"run": run_sizes(family, dtype), "dt_init": DT_INIT,
              "reference": REFERENCE[family]}
    return Cell(f"tiny-{family}", config, {**TINY_MIX, **mix}, limits,
                spec["end_to_end"], spec["per_layer"], reference(config))


class FakeClock:
    """A host clock that advances a fixed step at every reading, so that a
    window holds the same iterations however loaded the host is."""

    def __init__(self, step: float = 1e-3) -> None:
        self.now = 0.0
        self.step = step

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


def steady_clock(monkeypatch) -> None:
    """Give the harness's loop and cell one ``FakeClock``."""
    from bench import cell, loop
    clock = FakeClock()
    monkeypatch.setattr(loop, "time", clock)
    monkeypatch.setattr(cell, "time", clock)
