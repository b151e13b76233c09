"""TelemetryPlane — the DPU-analog observability fabric, end to end.

One ``DPUAgent`` per node plays the BlueField role: it subscribes to that
node's event stream, drives the full detector set at line rate, and exports
findings.  The ``TelemetryPlane`` aggregates agents cluster-wide, runs the
§4.2 attribution engine over the merged findings, and (optionally) closes
the loop through the mitigation controller — the paper's architecture in
~200 lines.

Overhead accounting is built in: the plane tracks wall-time spent in
update/poll so benchmarks can report the per-event cost (the paper's claim
is that this work belongs OFF the accelerator's critical path; here we prove
it is cheap enough to run on the host data path).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.attribution import Attribution, Attributor
from repro_torch.core.detectors import Detector, DetectorConfig, Finding
from repro_torch.core.events import Event, EventBatch, EventKind, EventStream
from repro_torch.core.mitigation import (
    ActionRecord,
    EngineControls,
    MitigationController,
    NullEngine,
)
from repro_torch.core.runbooks import DEFAULT_TABLES, build_detectors


@dataclass
class TelemetryStats:
    events: int = 0
    findings: int = 0
    attributions: int = 0
    actions: int = 0
    update_seconds: float = 0.0   # wall-time inside SAMPLED ingest windows
    timed_events: int = 0         # events covered by those windows
    poll_seconds: float = 0.0
    # per-detector-family breakdown, from *separate* sampled windows
    # (offset half a cadence from the plane-wide ones so the inner timer
    # pairs never sit inside — and inflate — the plane-wide measurement)
    det_seconds: dict = field(default_factory=dict)
    det_events: dict = field(default_factory=dict)

    def ns_per_event(self) -> float:
        """Per-event detector-update cost, from sampled timing windows.

        Timing is sampled (every Nth batch / Nth event), so the estimate
        measures detector work rather than the timer overhead that a
        per-event ``perf_counter`` pair would add to — and dominate on —
        the hot path.
        """
        if self.timed_events == 0:
            return 0.0
        return self.update_seconds / self.timed_events * 1e9

    def ns_per_event_by_detector(self) -> dict:
        """Per-detector-family cost (ns per event *that family saw*).

        Same every-Nth sampling cadence as :meth:`ns_per_event`; one
        slow detector no longer hides inside the plane-wide average.
        """
        out = {}
        for name, secs in self.det_seconds.items():
            n = self.det_events.get(name, 0)
            if n:
                out[name] = secs / n * 1e9
        return out


class DPUAgent:
    """Per-node line-rate observer: detector fan-out over one event stream.

    Two ingest paths share every detector's state:

      observe(ev)        — per-event compatibility path (kind-indexed
                           dispatch, exactly the seed behavior)
      observe_batch(b)   — columnar hot path: vectorized detectors get
                           per-kind sub-batches (each built once and shared
                           across all interested detectors); scalar fallback
                           detectors share one materialization of the batch.

    Overhead timing is sampled every ``sample_every`` batches (or events on
    the scalar path) so the measurement doesn't tax the path it measures.

    Batches below ``SMALL_BATCH`` rows replay through the per-event dispatch
    instead: the columnar path's fixed per-batch cost (per-kind filters,
    array slicing) only amortizes once a batch is ring-DMA-sized, and a
    producer emitting a handful of events per step (the live engine) must
    not pay 3x the scalar price for them.  Both paths are bit-identical, so
    the crossover is purely a performance choice.
    """

    SMALL_BATCH = 64

    def __init__(self, node: int, cfg: DetectorConfig | None = None,
                 tables: tuple[str, ...] = DEFAULT_TABLES,
                 full_trace: bool = False,
                 sample_every: int = 32) -> None:
        self.node = node
        self._cfg = cfg
        self._tables = tables
        self.detectors: dict[str, Detector] = build_detectors(cfg, tables)
        self.stream = EventStream(full_trace=full_trace)
        self.sample_every = max(sample_every, 1)
        # per-detector breakdown windows sit half a cadence away from the
        # plane-wide ones so their inner timer pairs never inflate the
        # plane-wide figure (disabled when sample_every == 1: every
        # window is already plane-timed)
        self._det_slot = self.sample_every // 2
        self._batches = 0
        self._index_detectors()
        self.stats = TelemetryStats()

    def _index_detectors(self) -> None:
        # pre-index detectors by event kind for O(interested) dispatch
        self._by_kind: dict[EventKind, list[Detector]] = {}
        for det in self.detectors.values():
            for kind in det.interested:
                self._by_kind.setdefault(kind, []).append(det)
        # batch dispatch plan: vectorized detectors receive per-kind
        # sub-batches (built once per present kind, shared across every
        # detector interested in it — each wire row is copied at most once);
        # scalar-fallback detectors share one per-event replay over a single
        # cached materialization, preserving cross-kind interleaving for the
        # pairing-sensitive rows (dispatch->D2H latency etc.)
        self._vec_dets: list[Detector] = []
        self._fallback_by_kind: dict[EventKind, list[Detector]] = {}
        for det in self.detectors.values():
            if type(det).update_batch is not Detector.update_batch:
                self._vec_dets.append(det)
            else:
                for kind in det.interested:
                    self._fallback_by_kind.setdefault(kind, []).append(det)
        self._fallback_kinds = frozenset(self._fallback_by_kind)
        # detector object -> runbook-row name, for the per-family
        # timing breakdown (rebuilt with the detectors after a crash)
        self._det_name: dict[int, str] = {
            id(det): name for name, det in self.detectors.items()}

    def reset_detectors(self) -> None:
        """Rebuild every detector from scratch — the DPU-crash model:
        detector state is DPU DRAM and does not survive a power cycle.
        Cumulative stats and the event stream are the *experiment's*
        record, not DPU state, so they survive."""
        self.detectors = build_detectors(self._cfg, self._tables)
        self._index_detectors()

    def _update_timed(self, dets, ev: Event) -> None:
        # per-detector breakdown window: one timer pair per update call
        names = self._det_name
        ds = self.stats.det_seconds
        de = self.stats.det_events
        for det in dets:
            d0 = time.perf_counter()
            det.update(ev)
            dt = time.perf_counter() - d0
            name = names[id(det)]
            ds[name] = ds.get(name, 0.0) + dt
            de[name] = de.get(name, 0) + 1

    def observe(self, ev: Event) -> None:
        stats = self.stats
        slot = stats.events % self.sample_every
        timed = slot == 0
        t0 = time.perf_counter() if timed else 0.0
        self.stream.emit(ev)
        if not timed and slot == self._det_slot:
            self._update_timed(self._by_kind.get(ev.kind, ()), ev)
        else:
            for det in self._by_kind.get(ev.kind, ()):
                det.update(ev)
        stats.events += 1
        if timed:
            stats.update_seconds += time.perf_counter() - t0
            stats.timed_events += 1

    def observe_batch(self, batch: EventBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        stats = self.stats
        slot = self._batches % self.sample_every
        timed = slot == 0
        det_timed = not timed and slot == self._det_slot
        self._batches += 1
        t0 = time.perf_counter() if timed else 0.0
        self.stream.emit_batch(batch)
        if n < self.SMALL_BATCH:
            # per-event replay: cheaper than columnar below the crossover
            by_kind = self._by_kind
            if det_timed:
                for ev in batch.iter_events():
                    self._update_timed(by_kind.get(ev.kind, ()), ev)
            else:
                for ev in batch.iter_events():
                    for det in by_kind.get(ev.kind, ()):
                        det.update(ev)
        else:
            kinds = batch.kind
            present = set(np.unique(kinds).tolist())
            single = len(present) == 1
            subs: dict[int, EventBatch] = {}
            names = self._det_name
            for det in self._vec_dets:
                for k in det.interested:
                    if k not in present:
                        continue
                    sub = subs.get(k)
                    if sub is None:
                        sub = batch if single else batch.compress(kinds == k)
                        subs[k] = sub
                    if det_timed:
                        d0 = time.perf_counter()
                        det.update_batch(sub)
                        dt = time.perf_counter() - d0
                        name = names[id(det)]
                        stats.det_seconds[name] = \
                            stats.det_seconds.get(name, 0.0) + dt
                        stats.det_events[name] = \
                            stats.det_events.get(name, 0) + len(sub)
                    else:
                        det.update_batch(sub)
            if self._fallback_kinds & present:
                fbk = self._fallback_by_kind
                if det_timed:
                    for ev in batch.iter_events():
                        self._update_timed(fbk.get(ev.kind, ()), ev)
                else:
                    for ev in batch.iter_events():
                        for det in fbk.get(ev.kind, ()):
                            det.update(ev)
        stats.events += n
        if timed:
            stats.update_seconds += time.perf_counter() - t0
            stats.timed_events += n

    def poll(self, now: float) -> list[Finding]:
        t0 = time.perf_counter()
        findings: list[Finding] = []
        for det in self.detectors.values():
            findings.extend(det.poll(now))
        self.stats.poll_seconds += time.perf_counter() - t0
        self.stats.findings += len(findings)
        return findings


class TelemetryPlane:
    """Cluster-wide aggregation + attribution + (optional) mitigation."""

    def __init__(self, n_nodes: int = 1,
                 cfg: DetectorConfig | None = None,
                 engine: EngineControls | None = None,
                 poll_interval: float = 0.25,
                 tables: tuple[str, ...] = DEFAULT_TABLES,
                 mitigate: bool = True,
                 full_trace: bool = False) -> None:
        self.cfg = cfg or DetectorConfig()
        # A single shared agent set sees the merged cluster stream (the
        # paper's "distributed view" aggregated at the telemetry collector);
        # per-node separation lives in the Event.node field, which every
        # detector already keys on.
        self.agent = DPUAgent(node=-1, cfg=self.cfg, tables=tables,
                              full_trace=full_trace)
        self.n_nodes = n_nodes
        self.attributor = Attributor()
        self.controller: MitigationController | None = None
        if mitigate:
            self.controller = MitigationController(engine or NullEngine())
        self.poll_interval = poll_interval
        self._next_poll = 0.0
        self.findings: list[Finding] = []
        self.attributions: list[Attribution] = []
        self.actions: list[ActionRecord] = []
        # dedup: (name, node) -> last finding ts, to avoid re-reporting the
        # same steady-state condition every poll
        self._last_seen: dict[tuple[str, int], float] = {}
        self.dedup_window = 1.0
        self._warming = False
        # observability (observe-only; None = disabled, the default)
        self.tracer = None
        self.trace_source = ""
        self.recorder = None

    # -- ingestion -------------------------------------------------------

    def observe(self, ev: Event) -> None:
        self.agent.observe(ev)
        if ev.ts >= self._next_poll:
            self.tick(ev.ts)
            self._next_poll = ev.ts + self.poll_interval

    def observe_batch(self, batch: EventBatch) -> None:
        """Columnar ingest — behaviorally identical to observing each event.

        The batch is split at poll boundaries: the scalar path polls at the
        first event whose ts crosses ``_next_poll``, so the batch path feeds
        the sub-batch up to AND INCLUDING that event, ticks at its timestamp,
        and continues — detectors see the same state at the same poll times
        either way (the equivalence property test asserts this).
        """
        n = len(batch)
        if n == 0:
            return
        ts = batch.ts
        if self.recorder is not None and not self._warming:
            # flight recorder: one ring append per delivered frame
            # (warm-start replays are historical, not fresh telemetry)
            self.recorder.on_batch(float(ts[n - 1]), batch)
        start = 0
        while True:
            # first event (in wire order — batches need not be globally
            # sorted) whose ts crosses the poll boundary, exactly like the
            # scalar path's per-event check
            crossed = ts[start:] >= self._next_poll
            if not crossed.any():
                if start == 0:
                    self.agent.observe_batch(batch)
                else:
                    self.agent.observe_batch(batch.slice(start, n))
                return
            i = start + int(np.argmax(crossed))
            self.agent.observe_batch(batch.slice(start, i + 1))
            now = float(ts[i])
            self.tick(now)
            self._next_poll = now + self.poll_interval
            start = i + 1
            if start >= n:
                return

    def observe_many(self, events) -> None:
        for ev in events:
            self.observe(ev)

    # -- chaos -----------------------------------------------------------

    def reset_detector_state(self) -> None:
        """DPU crash: all warm detector/attribution/dedup state is lost.
        The findings/attributions/actions logs survive — they are what the
        experiment already observed, not state on the failed device.

        The poll anchor resets with the detectors: a replay of retained
        history (watchdog failover) must tick at the *historical* poll
        boundaries, not accumulate silently until the pre-reset
        ``_next_poll`` — one giant catch-up window blurs exactly the rate
        sags and skews the replay was meant to preserve."""
        self.agent.reset_detectors()
        self.attributor._recent.clear()
        self._last_seen.clear()
        self._next_poll = 0.0

    def warm_start(self, batches) -> None:
        """Rebuild detector state by replaying retained history WITHOUT
        re-logging it — the host-side state transfer a supervisor performs
        when it hands control back to a restarted monitor.

        A power-cycled DPU that re-warms only on fault-era traffic
        calibrates its baselines to the fault: the pathology reads as
        normal and rate/peak-latch rows never fire again.  Replaying the
        supervisor's retained tap window (which spans pre-incident
        traffic) restores honest baselines.  Findings produced during the
        replay are discarded — the experiment record already holds what
        was observed live, and a replay must not duplicate it — and the
        dedup map is left unpopulated so the first *live* detection after
        the warm-start logs fresh.  Call ``reset_detector_state`` first;
        poll ticks then land on the historical boundaries and the anchor
        ends at the replay edge, so live ingest continues seamlessly."""
        s = self.agent.stats
        snap = (s.events, s.findings, s.update_seconds, s.timed_events,
                s.poll_seconds, dict(s.det_seconds), dict(s.det_events))
        self._warming = True
        try:
            for b in batches:
                self.observe_batch(b)
        finally:
            self._warming = False
            (s.events, s.findings, s.update_seconds, s.timed_events,
             s.poll_seconds, s.det_seconds, s.det_events) = snap

    # -- control path ----------------------------------------------------

    def tick(self, now: float) -> list[Finding]:
        raw = self.agent.poll(now)
        if self._warming:
            # warm-start replay: detectors drained at the historical poll
            # boundary, but nothing downstream — no log, no dedup mark,
            # no attribution, no actuation
            return []
        fresh: list[Finding] = []
        for f in raw:
            key = (f.name, f.node)
            last = self._last_seen.get(key, float("-inf"))
            if now - last >= self.dedup_window:
                fresh.append(f)
                self._last_seen[key] = now
        if not fresh:
            return []
        self.findings.extend(fresh)
        tracer = self.tracer
        if tracer is not None:
            for f in fresh:
                tracer.on_finding(f, self.trace_source)
        atts = self.attributor.observe(fresh)
        self.attributions.extend(atts)
        if tracer is not None:
            for a in atts:
                tracer.on_attribution(a, self.trace_source)
        self.agent.stats.attributions += len(atts)
        if self.controller is not None:
            acts = self.controller.consider_all(atts)
            self.actions.extend(acts)
            self.agent.stats.actions += len(acts)
        return fresh

    # -- reporting -------------------------------------------------------

    @property
    def stats(self) -> TelemetryStats:
        return self.agent.stats

    def report(self) -> dict:
        by_row: dict[str, int] = {}
        for f in self.findings:
            by_row[f.name] = by_row.get(f.name, 0) + 1
        by_locus: dict[str, int] = {}
        for a in self.attributions:
            by_locus[a.locus] = by_locus.get(a.locus, 0) + 1
        return {
            "events": self.stats.events,
            "findings": len(self.findings),
            "findings_by_row": by_row,
            "attributions_by_locus": by_locus,
            "actions": [(r.ts, r.action, r.node) for r in self.actions],
            "ns_per_event": self.stats.ns_per_event(),
            "ns_per_event_by_detector":
                self.stats.ns_per_event_by_detector(),
        }
