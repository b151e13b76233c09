"""Mean host time of the program's ``step.wait`` spans in the window: the
next tokens' argmax and their copy to the host, which waits for the
device to finish the step."""

from bench import program_spans


def read(ro):
    return program_spans.mean_ms(ro, "step.wait")
