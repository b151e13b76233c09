"""90th percentile of the program's ``request.queue`` spans (submission to
admission) over the requests admitted inside the window, wherever their
wait began (host clock)."""

from bench import program_spans
from bench.readout import percentile


def read(ro):
    spans = program_spans.window(ro, since=ro.t_open - ro.setup_s)
    t_open = round(ro.t_open * 1e9)
    waits = [s.end - s.start for s in spans or ()
             if s.name == program_spans.QUEUE and s.end >= t_open]
    ns = percentile(waits, 90)
    return None if ns is None else ns * 1e-6
