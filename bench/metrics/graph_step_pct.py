"""Share of the window's decode steps that the program issued as one
replayed CUDA graph: its ``step.replay`` spans over its ``step.enqueue``
spans, in percent; None where the window holds no ``step.enqueue``."""

from bench import program_spans


def read(ro):
    names = [s.name for s in program_spans.window(ro) or ()]
    steps = names.count("step.enqueue")
    return names.count("step.replay") / steps * 100 if steps else None
