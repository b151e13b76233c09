"""Mean host time of the program's ``step.enqueue`` spans in the window:
``Model.decode_step`` from its call until it returns with every launch
issued (the host time one CUDA graph a step would take away)."""

from bench import program_spans


def read(ro):
    return program_spans.mean_ms(ro, "step.enqueue")
