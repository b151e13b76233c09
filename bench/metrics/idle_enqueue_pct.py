"""Share of the traced window's device-idle time during which the host was
inside the program's ``step.enqueue`` or ``prefill.enqueue`` spans (mapped
onto the profiler's clock): the idle time that issuing launches explains,
in percent."""

from bench import program_spans


def read(ro):
    return program_spans.idle_pct(
        ro, lambda s: s.name in program_spans.ENQUEUE)
