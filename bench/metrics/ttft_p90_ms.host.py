"""90th percentile, over every request submitted inside the window, of the
time from its submission to the return of the step that emits its first
token (host clock); a request without a first token at the window's close
counts with the time it has waited so far."""

from bench.readout import percentile


def read(ro):
    waits = []
    for r in ro.requests:
        if ro.t_open <= r.submitted <= ro.t_close:
            end = r.first if 0 <= r.first <= ro.t_close else ro.t_close
            waits.append(end - r.submitted)
    ms = percentile(waits, 90)
    return None if ms is None else ms * 1e3
