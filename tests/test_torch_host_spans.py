"""The serving engine's host-clock spans (``repro_torch.obs.hostspans``): the
span tree a tiny engine run leaves, ``iterate`` as ``run``'s body, the
bounded ring, and the mapping onto ``torch.profiler``'s clock."""

import statistics
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    HOST_SPANS,
    ExpertSteps,
    HostSpans,
    hostspans,
    to_profiler_ns,
)
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402
from torch_graphs import capture_prefills, install  # noqa: E402

NAMES = {"request.queue", "engine.admit", "engine.prefill",
         "prefill.enqueue", "prefill.wait", "engine.step", "step.enqueue",
         "step.wait", "engine.flush"}
PARENT = {"request.queue": None, "engine.admit": None, "engine.step": None,
          "engine.flush": None, "engine.prefill": "engine.admit",
          "prefill.enqueue": "engine.prefill",
          "prefill.wait": "engine.prefill", "step.enqueue": "engine.step",
          "step.wait": "engine.step", "step.replay": "step.enqueue",
          "prefill.replay": "prefill.enqueue"}


@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_model(ARCHS["qwen3-0.6b"].reduced(), device="cpu", seed=1)
    torch.set_num_threads(n)


def _requests():
    return [ServeRequest(10 + i, i * 0.003, [1 + i] * (5 + 3 * i), 3 + i % 3)
            for i in range(6)]


def _engine(model, node=3):
    return InferenceEngine(model, EngineConfig(max_slots=4, max_seq=64,
                                               node=node, control="dpu"))


def test_engine_run_leaves_the_span_tree(model):
    eng = _engine(model)
    t0 = time.perf_counter_ns()
    rep = eng.run(_requests())
    spans = HOST_SPANS.within(t0, time.perf_counter_ns())
    by_index = {s.index: s for s in spans}
    assert {s.name for s in spans} == NAMES
    assert all(s.node == 3 and s.start <= s.end for s in spans)
    for s in spans:
        want = PARENT[s.name]
        if want is None:
            assert s.parent == -1
            continue
        up = by_index[s.parent]
        assert up.name == want
        assert up.start <= s.start and s.end <= up.end
        if want == "engine.prefill":
            assert s.rid == up.rid

    def named(name):
        return [s for s in spans if s.name == name]
    rids = sorted(r.req_id for r in _requests())
    assert sorted(s.rid for s in named("request.queue")) == rids
    assert sorted(s.rid for s in named("engine.prefill")) == rids
    assert {s.rid for s in named("engine.step")} == {-1}
    # each request waits in the queue until its prefill starts
    queued = {s.rid: s for s in named("request.queue")}
    for p in named("engine.prefill"):
        assert queued[p.rid].end <= p.start
    # one step span a step, each with its enqueue then its wait
    assert len(named("engine.step")) == rep["steps"]
    for step in named("engine.step"):
        kids = [s for s in spans if s.parent == step.index]
        assert [s.name for s in kids] == ["step.enqueue", "step.wait"]
        assert kids[0].end <= kids[1].start
    # one admission and one flush an iteration, and the report's flush
    assert len(named("engine.admit")) >= rep["steps"]
    assert len(named("engine.flush")) == len(named("engine.admit")) + 1


def test_a_replayed_step_opens_its_replay_inside_the_enqueue(model):
    eng = _engine(model)
    graph = install(eng)
    t0 = time.perf_counter_ns()
    rep = eng.run(_requests())
    spans = HOST_SPANS.within(t0, time.perf_counter_ns())
    by_index = {s.index: s for s in spans}
    assert {s.name for s in spans} == NAMES | {"step.replay"}
    replays = [s for s in spans if s.name == "step.replay"]
    assert len(replays) == graph.replays == rep["steps"]
    for s in replays:
        up = by_index[s.parent]
        assert up.name == PARENT[s.name] == "step.enqueue"
        assert up.start <= s.start and s.end <= up.end
    # no span nests in a replay
    assert not {s.parent for s in spans} & {s.index for s in replays}
    for step in (s for s in spans if s.name == "engine.step"):
        kids = [s for s in spans if s.parent == step.index]
        assert [s.name for s in kids] == ["step.enqueue", "step.wait"]


def test_a_replayed_prefill_opens_its_replay_inside_the_enqueue(model):
    eng = _engine(model)
    capture_prefills(eng)
    t0 = time.perf_counter_ns()
    eng.run(_requests() + [ServeRequest(20, 0.02, [4] * 70, 2)])
    spans = HOST_SPANS.within(t0, time.perf_counter_ns())
    by_index = {s.index: s for s in spans}
    assert {s.name for s in spans} == NAMES | {"prefill.replay"}
    replays = [s for s in spans if s.name == "prefill.replay"]
    # two buckets (64, 128), each captured once and replayed after
    assert len(replays) == sum(g.graph.replays
                               for g in eng._prefills.values()) == 5
    for s in replays:
        up = by_index[s.parent]
        assert up.name == PARENT[s.name] == "prefill.enqueue"
        assert up.start <= s.start and s.end <= up.end and s.rid == up.rid
    assert not {s.parent for s in spans} & {s.index for s in replays}
    for p in (s for s in spans if s.name == "engine.prefill"):
        kids = [s for s in spans if s.parent == p.index]
        assert [s.name for s in kids] == ["prefill.enqueue", "prefill.wait"]


def test_iterate_is_the_body_of_run(model):
    a, b = _engine(model), _engine(model)
    rep = a.run(_requests(), max_steps=40)
    pending = sorted(_requests(), key=lambda r: r.arrival)
    for _ in range(40):
        now = b.clock + 2e-3
        due = [r for r in pending if r.arrival <= now]
        pending = pending[len(due):]
        b.iterate(due)
        if not pending and not b.sched.running and not b.sched.queue:
            break
    assert _strip(b.report()) == _strip(rep)
    assert [(r.req_id, r.tokens_out, r.first_token, r.finished)
            for r in b.completed] == [(r.req_id, r.tokens_out,
                                        r.first_token, r.finished)
                                       for r in a.completed]


def _strip(rep):
    """The report without the telemetry plane's wall-clock timings."""
    tel = {k: v for k, v in rep["telemetry"].items()
           if not k.startswith("ns_per_event")}
    return {**rep, "telemetry": tel}


@pytest.mark.parametrize("call", ["prefill", "decode_step"])
def test_a_raising_call_leaves_the_nesting_whole(model, call):
    eng = _engine(model)
    eng.run(_requests()[:1], max_steps=2)

    def broken(*a, **kw):
        raise RuntimeError("device lost")
    setattr(eng.model, call, broken)
    try:
        with pytest.raises(RuntimeError):
            eng.iterate(_requests()[1:2])
    finally:
        delattr(eng.model, call)
    t0 = time.perf_counter_ns()
    eng.iterate(_requests()[2:3])
    spans = HOST_SPANS.within(t0, time.perf_counter_ns())
    assert [s.name for s in spans if s.parent == -1] == [
        "request.queue", "engine.admit", "engine.step", "engine.flush"]


def test_the_engine_emits_no_profiler_annotation(model):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(_requests()[:2])
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not names & NAMES


def _spans(record, ks):
    times = []
    for k in ks:
        h = record.open(f"s{k}", k, 0)
        record.close(h)
        times.append((h[2], time.perf_counter_ns()))
    return times


def test_the_ring_drops_the_oldest_and_says_so():
    record = HostSpans(capacity=4)
    times = _spans(record, range(3))
    assert record.dropped == 0
    assert [s.name for s in record.within(0, 2**62)] == ["s0", "s1", "s2"]
    times += _spans(record, range(3, 6))
    assert record.dropped == 2
    # the ring keeps s2..s5: an interval from before s2's end may have
    # held a dropped span, so it gives none rather than a part
    assert record.within(0, 2**62) is None
    assert record.within(times[1][0], 2**62) is None
    held = record.within(times[2][1] + 1, 2**62)
    assert [s.name for s in held] == ["s3", "s4", "s5"]
    assert [s.rid for s in held] == [3, 4, 5]
    assert record.within(times[3][0], times[4][1]) is not None
    assert [s.name for s in record.within(times[3][0], times[4][1])] \
        == ["s3", "s4"]


def test_nesting_and_spans_outside_it():
    record = HostSpans()
    outer = record.open("outer")
    wait = record.begin("wait", rid=7)
    inner = record.open("inner")
    record.end(wait)
    record.close(inner)
    after = record.open("after")
    record.close(after)
    record.close(outer)
    top = record.open("top")
    record.close(top)
    spans = {s.name: s for s in record.within(0, 2**62)}
    assert spans["inner"].parent == spans["outer"].index
    assert spans["after"].parent == spans["outer"].index
    assert spans["wait"].parent == -1 and spans["wait"].rid == 7
    assert spans["top"].parent == -1 and spans["outer"].parent == -1


def test_spans_meet_record_function_on_the_profilers_clock():
    """Mapped, a span and a ``record_function`` around the same body
    agree to 0.2 ms at both ends (the median of nine bodies: a loaded
    host delays single exits)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    record = HostSpans()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(9):
            with record_function(f"body{k}"):
                h = record.open(f"body{k}")
                for _ in range(20):
                    x = torch.tanh(x @ x.T * 1e-3)
                time.sleep(2e-3)
                record.close(h)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    starts, ends = [], []
    for span in record.within(0, 2**62):
        ev = events[span.name]
        starts.append(to_profiler_ns(span.start) - ev.start_ns())
        ends.append(to_profiler_ns(span.end)
                    - (ev.start_ns() + ev.duration_ns()))
    assert len(starts) == 9
    tol = 200_000                                   # 0.2 ms
    assert abs(statistics.median(starts)) < tol
    assert abs(statistics.median(ends)) < tol


def test_the_expert_steps_ring_drops_the_oldest_alike(monkeypatch):
    clock = iter(range(10, 100, 10))
    monkeypatch.setattr(hostspans, "perf_counter_ns", lambda: next(clock))
    record = ExpertSteps(capacity=2)
    for i in range(3):
        record.book(i, i, 4)
    assert record.dropped == 1
    assert [s.t for s in record._ring] == [20, 30]
    # an interval reaching back to the oldest step kept may have held the
    # dropped one: none rather than a part
    assert record.within(0, 2**62) is None
    assert record.within(20, 2**62) is None
    assert [s.pairs for s in record.within(21, 2**62)] == [2]
