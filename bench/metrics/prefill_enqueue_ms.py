"""Mean host time of the program's ``prefill.enqueue`` spans in the window:
``Model.prefill`` with its read-back of the positions, until it returns
with every launch issued."""

from bench import program_spans


def read(ro):
    return program_spans.mean_ms(ro, "prefill.enqueue")
