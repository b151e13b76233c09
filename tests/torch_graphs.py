"""A stand-in for a CUDA graph on the CPU, for the tests of the engine's
replayed decode step (``serving.engine.StepGraph``)."""

import contextlib

from repro_torch.serving.engine import StepGraph


class CpuGraph:
    """What ``torch.cuda.CUDAGraph`` does for the engine, on the CPU:
    ``record`` is the step a capture records (run once here, as the
    capture's body), ``replay`` runs the step again and leaves its output
    in the recorded output's tensor, as a replay rewrites the graph's
    static output."""

    def __init__(self, body) -> None:
        self.body = body
        self.out = None
        self.replays = 0

    def record(self):
        self.out = self.body()
        return self.out

    def replay(self) -> None:
        self.replays += 1
        self.out.copy_(self.body())


def install(engine) -> CpuGraph:
    """Give ``engine`` a graph of its decode step on the CPU, so that every
    step replays it.  Recording runs one step on the engine's idle slots,
    whose rows every admission overwrites."""
    graph = CpuGraph(engine._decode_body)
    engine._graph = StepGraph(graph.record, graph,
                              lambda g: contextlib.nullcontext())
    return graph
