"""Share of the traced window's device-idle time during which the host was
inside the program's other engine spans (``engine.*`` outside their
enqueues, the waits; ``request.queue`` aside), in percent.  With
``idle_enqueue_pct`` the rest is the harness's own code."""

from bench import program_spans


def read(ro):
    engine = program_spans.idle_pct(
        ro, lambda s: s.name != program_spans.QUEUE)
    if engine is None:
        return None
    return engine - program_spans.idle_pct(
        ro, lambda s: s.name in program_spans.ENQUEUE)
