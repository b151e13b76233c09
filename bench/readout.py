"""What one run hands to the metric readers (``bench/metrics/<name>.py``).

Each reader is a module with ``read(ro: Readout) -> float | None``; it
returns None where its cell gives it nothing to read, and the metric is
then left out of the result line.  A reader that counts a model's work
takes it from ``Readout.counts``: what the configuration's reference module
states (``bench/work.py``'s ``Counts``)."""

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
    reference: object = None  # the configuration's reference module

    @property
    def counts(self):
        """The model's work, as its reference module states it."""
        return self.reference.counts(self.run)

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


def module(path: Path, name: str):
    """The Python file at ``path``, loaded as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return module(METRICS / f"{name}.py", f"bench_metric_{name}").read
