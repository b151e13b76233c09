"""95th percentile of every gap between successive output tokens of one
request that ends inside the window, each token stamped when the step that
emitted it returns (host clock)."""

from bench.readout import percentile


def read(ro):
    gaps = []
    for r in ro.requests:
        st = r.stamps
        gaps += [b - a for a, b in zip(st, st[1:])
                 if ro.t_open <= b <= ro.t_close]
    ms = percentile(gaps, 95)
    return None if ms is None else ms * 1e3
