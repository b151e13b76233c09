"""A stand-in for a CUDA graph on the CPU, for the tests of the engine's
replayed decode step and prefills (``serving.engine.StepGraph``)."""

import contextlib

from repro_torch.kernels import ops
from repro_torch.serving.engine import StepGraph


class CpuGraph:
    """What ``torch.cuda.CUDAGraph`` does for the engine, on the CPU:
    ``record`` is the body a capture records (run once here, as the
    capture's body), ``replay`` runs the body again and leaves its output
    in the recorded output's tensor, as a replay rewrites the graph's
    static output.  A replay calls no kernel wrapper, so what the body's
    run counts as launches is taken back (``StepGraph`` books the
    capture's)."""

    def __init__(self, body) -> None:
        self.body = body
        self.out = None
        self.replays = 0

    def record(self):
        self.out = self.body()
        return self.out

    def replay(self) -> None:
        self.replays += 1
        before = ops.launch_counts()
        self.out.copy_(self.body())
        ops.add_launch_counts({name: before[name] - n for name, n
                               in ops.launch_counts().items()})


def stand_in(body) -> StepGraph:
    """``body`` recorded into a ``CpuGraph`` as a capture records it."""
    graph = CpuGraph(body)
    return StepGraph(graph.record, graph, lambda g: contextlib.nullcontext())


def install(engine) -> CpuGraph:
    """Give ``engine`` a graph of its decode step on the CPU, so that every
    step replays it.  Recording runs one step on the engine's idle slots,
    whose rows every admission overwrites."""
    engine._graph = stand_in(engine._decode_body)
    return engine._graph.graph


def capture(body):
    """``serving.engine.capture_step`` on the CPU: ``body`` run once (the
    warm-up, a real run), then recorded.  Returns the run's output and the
    graph."""
    out = body()
    return out, stand_in(body)


def capture_prefills(engine) -> None:
    """Make ``engine`` capture its prefills as it does on the card: each
    bucket's first prefill runs and records a graph (``capture``), which
    every later prefill of the bucket replays; ``engine._prefills[bucket]
    .graph`` is the bucket's ``CpuGraph``."""
    engine._capture_prefill = capture
