"""``graph_step_pct``'s reader on hand-built program spans: the share of
the window's decode steps issued as a replayed CUDA graph."""

import pytest

from bench import program_spans
from bench.readout import Readout, reader
from bench.tiny import TINY_MIX, run_sizes

MS = 1_000_000


def span(index, name, t0, t1, parent=-1):
    from repro_torch.obs import HostSpan
    return HostSpan(index, name, round(t0 * MS), round(t1 * MS), parent, -1,
                    0)


def steps(replayed: int, eager: int) -> list:
    """``replayed`` + ``eager`` decode steps inside the window (1-2 s), a
    replay inside each of the first ``replayed`` enqueues, and a replayed
    step before the window."""
    out = [span(0, "engine.step", 900, 950),
           span(1, "step.enqueue", 901, 902, 0),
           span(2, "step.replay", 901.2, 901.8, 1)]
    for k in range(replayed + eager):
        t, i = 1010 + 50 * k, 3 + 4 * k
        out += [span(i, "engine.step", t, t + 40),
                span(i + 1, "step.enqueue", t + 1, t + 2, i),
                span(i + 2, "step.wait", t + 2, t + 39, i)]
        if k < replayed:
            out.append(span(i + 3, "step.replay", t + 1.2, t + 1.8, i + 1))
    return out


class Record:
    def __init__(self, spans):
        self.spans = spans

    def within(self, t0, t1):
        return [s for s in self.spans if s.start >= t0 and s.end <= t1]


def read(monkeypatch, spans):
    monkeypatch.setattr(program_spans, "source", lambda: (
        Record(spans), lambda t: t))
    ro = Readout(run_sizes("moe"), TINY_MIX, 0.9, 1.0, 2.0, [], [])
    return reader("graph_step_pct")(ro)


@pytest.mark.parametrize("replayed, eager, want", [
    (6, 0, 100.0), (0, 5, 0.0), (3, 1, 75.0)])
def test_share_of_replayed_steps(monkeypatch, replayed, eager, want):
    assert read(monkeypatch, steps(replayed, eager)) == pytest.approx(want)


def test_silent_without_a_step(monkeypatch):
    assert read(monkeypatch, []) is None
    # a window with only spans outside the decode step
    assert read(monkeypatch, [span(0, "engine.flush", 1100, 1101)]) is None
    monkeypatch.setattr(program_spans, "source", lambda: None)
    ro = Readout(run_sizes("moe"), TINY_MIX, 0.9, 1.0, 2.0, [], [])
    assert reader("graph_step_pct")(ro) is None
