"""Share of the window's prefills that the program issued as one replayed
CUDA graph: its ``prefill.replay`` spans over its ``prefill.enqueue``
spans, in percent; None where the window holds no ``prefill.enqueue``."""

from bench import program_spans


def read(ro):
    names = [s.name for s in program_spans.window(ro) or ()]
    prefills = names.count("prefill.enqueue")
    return names.count("prefill.replay") / prefills * 100 if prefills \
        else None
