"""What one run hands to the metric readers (``bench/metrics/<name>.py``).

Each reader is a module with ``read(ro: Readout) -> float | None``; it
returns None where its cell gives it nothing to read, and the metric is
then left out of the result line."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

METRICS = Path(__file__).resolve().parent / "metrics"


@dataclass
class Readout:
    run: dict                 # the model's sizes (the configuration's "run")
    mix: dict                 # the traffic mix
    setup_s: float
    t_open: float             # host clock, s
    t_close: float
    iterations: list          # loop.Iteration, all of them
    requests: list            # traffic.Request, all of them
    page_size: int = 16       # the engine's KV page
    trace: object = None      # trace.Trace of the traced iterations
    traced: list = field(default_factory=list)   # the traced iterations

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def window(self) -> list:
        """The iterations inside the window."""
        return [it for it in self.iterations
                if it.t0 >= self.t_open and it.t1 <= self.t_close]

    def kernel_s(self, symbols: tuple[str, ...]) -> float:
        """Device seconds of the traced kernels whose name holds one of
        ``symbols``."""
        return sum(e - s for name, _, s, e, _ in self.trace.kernels()
                   if any(sym in name for sym in symbols)) * 1e-9


def percentile(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
