"""The readers of the program's host-clock spans on hand-built spans and a
hand-built trace: each returns the value worked out by hand, and None
where the cell gives it nothing."""

import pytest

from bench import program_spans
from bench.loop import Iteration
from bench.readout import Readout, reader
from bench.tiny import TINY_MIX, run_sizes
from bench.trace import Trace

MS = 1_000_000
SHIFT = 7 * 10**17              # the profiler's clock against the host's


def at(ms: float) -> int:
    """Host-clock ns of ``ms`` milliseconds after the clock's zero."""
    return round(ms * MS)


def prof(ms: float) -> int:
    return at(ms) + SHIFT


def span(index, name, t0, t1, parent=-1, rid=-1):
    from repro_torch.obs import HostSpan
    return HostSpan(index, name, at(t0), at(t1), parent, rid, 0)


# the untraced window, 1000-2000 ms: two steps, one prefill, three
# requests admitted (one of them queued since before the window)
WINDOW = [
    span(0, "request.queue", 200, 900, rid=0),
    span(1, "request.queue", 500, 1010, rid=1),
    span(2, "engine.admit", 1010, 1050),
    span(3, "engine.prefill", 1011, 1049, 2, rid=1),
    span(4, "prefill.enqueue", 1012, 1040, 3, rid=1),
    span(5, "prefill.wait", 1045, 1048, 3, rid=1),
    span(6, "engine.step", 1050, 1150),
    span(7, "step.enqueue", 1052, 1130, 6),
    span(8, "step.wait", 1131, 1140, 6),
    span(9, "engine.flush", 1150, 1151),
    span(10, "request.queue", 1100, 1160, rid=2),
    span(11, "request.queue", 1120, 1200, rid=3),
    span(12, "engine.step", 1200, 1300),
    span(13, "step.enqueue", 1202, 1284, 12),
    span(14, "step.wait", 1285, 1296, 12),
    span(15, "request.queue", 1900, 2500, rid=4),
]
# the traced iterations, 2100-2301 ms
TRACED = [
    span(20, "engine.step", 2100, 2200),
    span(21, "step.enqueue", 2102, 2180, 20),
    span(22, "step.wait", 2181, 2195, 20),
    span(23, "engine.flush", 2200, 2201),
    span(24, "engine.admit", 2201, 2260),
    span(25, "engine.prefill", 2202, 2258, 24, rid=5),
    span(26, "prefill.enqueue", 2203, 2240, 25, rid=5),
    span(27, "prefill.wait", 2250, 2256, 25, rid=5),
    span(28, "engine.step", 2260, 2300),
    span(29, "step.enqueue", 2262, 2290, 28),
    span(30, "step.wait", 2291, 2299, 28),
    span(31, "request.queue", 2280, 2300.8, rid=6),
]
# (launch, device start, device end) in ms, on the profiler's clock
OPS = {
    1: ("gemm", "kernel", 2105, 2110, 2130),        # step 1's enqueue
    2: ("paged", "kernel", 2170, 2175, 2185),       # step 1's enqueue
    3: ("Memcpy HtoD", "gpu_memcpy", 2100.5, 2101, 2102),  # the tokens
    4: ("argmax", "kernel", 2182, 2185, 2186),      # step 1's wait
    5: ("ssd", "kernel", 2210, 2212, 2245),         # the prefill
    6: ("gemm", "kernel", 2265, 2270, 2290),        # step 2's enqueue
}


class Record:
    def __init__(self, spans):
        self.spans = spans

    def within(self, t0, t1):
        return [s for s in self.spans if s.start >= t0 and s.end <= t1]


def trace() -> Trace:
    ops = [(name, kind, prof(s), prof(e), corr)
           for corr, (name, kind, _, s, e) in OPS.items()]
    return Trace((prof(2099), prof(2301)), ops=ops,
                 launches={corr: prof(v[2]) for corr, v in OPS.items()})


def readout(traced=True, spans=WINDOW + TRACED) -> Readout:
    its = [Iteration(2.1, 2.201, running=4), Iteration(2.201, 2.301)]
    return Readout(run_sizes("hybrid"), TINY_MIX, 0.9, 1.0, 2.0, [], [],
                   trace=trace() if traced else None,
                   traced=its if traced else [])


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(program_spans, "source", lambda: (
            Record(spans), lambda t: t + SHIFT))
    use(WINDOW + TRACED)
    return use


def test_window_means(program):
    ro = readout()
    assert reader("step_enqueue_ms")(ro) == pytest.approx((78 + 82) / 2)
    assert reader("step_wait_ms")(ro) == pytest.approx((9 + 11) / 2)
    assert reader("prefill_enqueue_ms")(ro) == pytest.approx(28)


def test_queue_wait_counts_every_request_admitted_in_the_window(program):
    # waits of 510, 60 and 80 ms end inside; rid 0 ends before, rid 4
    # after: the 90th percentile of [60, 80, 510] is 80 + 0.8 x 430
    ro = readout()
    assert reader("queue_wait_p90_ms.host")(ro) == pytest.approx(424)


def test_step_device_time(program):
    # 20 + 10 ms launched in the first step's enqueue, 20 in the second's;
    # the token copy and the argmax are outside the enqueues
    assert reader("step_device_ms")(readout()) == pytest.approx(25)


def test_idle_shares(program):
    # idle: 2099-2101, 2102-2110, 2130-2175, 2186-2212, 2245-2270,
    # 2290-2301: 117 ms.  Inside an enqueue: 8 + 45 + 9 + 8 = 70 ms.
    # Inside any engine span (2100-2300; the queue's 2300-2300.8 does not
    # count): 1 + 8 + 45 + 26 + 25 + 10 = 115 ms
    ro = readout()
    assert sum(e - s for s, e in program_spans.idle(ro.trace)) == 117 * MS
    assert reader("idle_enqueue_pct")(ro) == pytest.approx(70 / 117 * 100)
    assert reader("idle_engine_pct")(ro) == pytest.approx(45 / 117 * 100)


def test_silent_where_the_cell_gives_nothing(program):
    no_trace = readout(traced=False)
    for name in ("step_device_ms", "idle_enqueue_pct", "idle_engine_pct"):
        assert reader(name)(no_trace) is None
    assert reader("step_enqueue_ms")(no_trace) == pytest.approx(80)
    program([s for s in WINDOW + TRACED if not s.name.startswith(
        ("engine.prefill", "prefill."))])
    assert reader("prefill_enqueue_ms")(readout()) is None
    assert reader("step_enqueue_ms")(readout()) == pytest.approx(80)


def test_silent_on_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "source", lambda: None)
    for name in ("step_enqueue_ms", "step_wait_ms", "step_device_ms",
                 "prefill_enqueue_ms", "queue_wait_p90_ms.host",
                 "idle_enqueue_pct", "idle_engine_pct"):
        assert reader(name)(readout()) is None


def test_the_program_holds_the_record():
    from repro_torch.obs import HOST_SPANS, to_profiler_ns
    assert program_spans.source() == (HOST_SPANS, to_profiler_ns)


def test_union_and_overlap():
    assert program_spans.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) \
        == [(0, 3), (5, 8)]
    assert program_spans.overlap([(0, 3), (5, 8)], [(2, 6), (7, 20)]) \
        == 1 + 1 + 1
