"""``graph_prefill_pct``'s reader on hand-built program spans: the share of
the window's prefills issued as a replayed CUDA graph."""

import pytest

from bench import program_spans
from bench.readout import Readout, reader
from bench.tiny import TINY_MIX, run_sizes

MS = 1_000_000


def span(index, name, t0, t1, parent=-1, rid=-1):
    from repro_torch.obs import HostSpan
    return HostSpan(index, name, round(t0 * MS), round(t1 * MS), parent, rid,
                    0)


def prefills(replayed: int, eager: int) -> list:
    """``replayed`` + ``eager`` prefills inside the window (1-2 s), a
    replay inside each of the first ``replayed`` enqueues, each decode step
    replayed; and a replayed prefill before the window."""
    out = [span(0, "engine.prefill", 900, 950, rid=0),
           span(1, "prefill.enqueue", 901, 902, 0, rid=0),
           span(2, "prefill.replay", 901.2, 901.8, 1, rid=0)]
    for k in range(replayed + eager):
        t, i = 1010 + 50 * k, 3 + 7 * k
        out += [span(i, "engine.prefill", t, t + 20, rid=k + 1),
                span(i + 1, "prefill.enqueue", t + 1, t + 2, i, rid=k + 1),
                span(i + 2, "prefill.wait", t + 2, t + 19, i, rid=k + 1),
                span(i + 3, "engine.step", t + 21, t + 40),
                span(i + 4, "step.enqueue", t + 22, t + 23, i + 3),
                span(i + 5, "step.replay", t + 22.2, t + 22.8, i + 4)]
        if k < replayed:
            out.append(span(i + 6, "prefill.replay", t + 1.2, t + 1.8,
                            i + 1, rid=k + 1))
    return out


class Record:
    def __init__(self, spans):
        self.spans = spans

    def within(self, t0, t1):
        return [s for s in self.spans if s.start >= t0 and s.end <= t1]


def read(monkeypatch, spans):
    monkeypatch.setattr(program_spans, "source", lambda: (
        Record(spans), lambda t: t))
    ro = Readout(run_sizes("hybrid"), TINY_MIX, 0.9, 1.0, 2.0, [], [])
    return reader("graph_prefill_pct")(ro)


@pytest.mark.parametrize("replayed, eager, want", [
    (6, 0, 100.0), (0, 5, 0.0), (3, 1, 75.0), (19, 1, 95.0)])
def test_share_of_replayed_prefills(monkeypatch, replayed, eager, want):
    assert read(monkeypatch, prefills(replayed, eager)) == \
        pytest.approx(want)


def test_silent_without_a_prefill(monkeypatch):
    assert read(monkeypatch, []) is None
    # a window of decode steps alone, each replayed
    steps = [s for s in prefills(4, 0) if s.start >= 1000 * MS
             and not s.name.startswith(("engine.prefill", "prefill."))]
    assert steps and read(monkeypatch, steps) is None
    monkeypatch.setattr(program_spans, "source", lambda: None)
    ro = Readout(run_sizes("hybrid"), TINY_MIX, 0.9, 1.0, 2.0, [], [])
    assert reader("graph_prefill_pct")(ro) is None
