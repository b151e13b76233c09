"""The trace reduction on hand-made profiler events: busy time, idle gaps
named by the host span, and kernels counted by where they were launched."""

from types import SimpleNamespace

import pytest

from bench.trace import reduce


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, note=False):
        self._v = (name, dev, start, dur, corr, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


EVENTS = [
    Ev("traced_window", "CPU", 0, 1000, note=True),
    Ev("decode_step", "CPU", 100, 300, note=True),
    Ev("telemetry_flush", "CPU", 400, 200, note=True),
    Ev("cudaLaunchKernel", "CPU", 110, 5, corr=1),
    Ev("cudaLaunchKernel", "CPU", 150, 5, corr=2),
    Ev("cudaMemcpyAsync", "CPU", 160, 5, corr=9),
    Ev("cudaLaunchKernel", "CPU", 650, 5, corr=3),
    Ev("aten::mm", "CPU", 105, 50),
    Ev("paged_split_kernel<bf16>", "CUDA", 120, 80, corr=1),
    Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 180, 40, corr=9),
    Ev("sm90_gemm", "CUDA", 300, 100, corr=2),
    Ev("sm90_gemm", "CUDA", 660, 40, corr=3),
]


def test_busy_idle_and_launches():
    tr = reduce(prof(EVENTS), "traced_window")
    assert tr.window_s == pytest.approx(1e-6)
    # busy: [120, 220) and [300, 400) and [660, 700)
    assert tr.busy_s() == pytest.approx(240e-9)
    gaps = dict()
    for name, ns in tr.idle_gaps():
        gaps[name] = gaps.get(name, 0) + ns
    assert gaps == {"loop": 120 + 300, "decode_step": 80,
                    "telemetry_flush": 260}
    assert tr.launched_in("decode_step") == 2
    assert len(tr.kernels()) == 3


def test_device_time_goes_to_the_span_that_issued_it():
    tr = reduce(prof(EVENTS), "traced_window")
    by_span = tr.device_s_by_span()
    assert by_span["decode_step"] == pytest.approx((80 + 40 + 100) * 1e-9)
    assert by_span["loop"] == pytest.approx(40e-9)


def test_idle_scales_traced_device_time_to_the_window():
    """2 ms of device time a traced step and 0.05 ms a prefill token,
    against an untraced window of 10 steps and 400 prefill tokens in
    1 s: 40 ms busy, so 96% idle."""
    from bench.loop import Iteration
    from bench.readout import Readout, reader
    from bench.tiny import TINY_MIX, run_sizes
    from bench.trace import Trace
    ms = 1_000_000
    tr = Trace((0, 100 * ms),
               ops=[("gemm", "kernel", 1 * ms, 3 * ms, 1),
                    ("gemm", "kernel", 11 * ms, 13 * ms, 2),
                    ("ssd", "kernel", 20 * ms, 25 * ms, 3)],
               spans=[("decode_step", 0, 10 * ms),
                      ("decode_step", 10 * ms, 20 * ms),
                      ("admit", 20 * ms, 30 * ms),
                      ("prefill", 20 * ms, 30 * ms)],
               launches={1: 0, 2: 10 * ms, 3: 21 * ms})
    traced = [Iteration(0.0, 0.01, running=4),
              Iteration(0.01, 0.03, prefills=[(100, 90, 0.01)], running=4)]
    window = [Iteration(k / 10, (k + 1) / 10, running=4,
                        prefills=[(100, 90, 0.01)] if k < 4 else [])
              for k in range(10)]
    ro = Readout(run_sizes("moe"), TINY_MIX, 1.0, 0.0, 1.0, window, [],
                 trace=tr, traced=traced)
    assert reader("device_idle_pct")(ro) == pytest.approx(96.0)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        reduce(prof(EVENTS[1:]), "traced_window")
