"""The port's copy of the observability layer (``repro_torch.obs``) and of
the runbook export (``repro_torch.core.export``) against the JAX package's:
the same hook sequence into a Tracer and a FlightRecorder, and the same
traced DPU loops, must give equal incident reports, counters, recorder
snapshots and metrics text, exactly."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import PACKAGES, package, plain

ROOT = Path(__file__).resolve().parents[1]


def _ns(pkg: str):
    return package(pkg, "core.events", "core.detectors", "core.telemetry",
                   "core.export", "dpu", "obs")


def _batch(P, ts0, n=6, kv=False):
    """n rows from ts0 on; with ``kv`` every other row is a KV-occupancy
    queue sample (the rows a recorder snapshot keeps)."""
    b = P.EventBatchBuilder()
    for i in range(n):
        meta = P.META_KV_OCC if kv and i % 2 else P.META_TAP_DEBUG
        b.add(ts0 + i * 1e-3, int(P.EventKind.QUEUE_SAMPLE), i % 3,
              depth=10 * i, size=i, meta=meta)
    return b.build(sort=True)


def _f(name="tp_straggler", node=2, ts=1.5, severity="warn", score=5.0):
    return SimpleNamespace(name=name, node=node, ts=ts, severity=severity,
                           score=score)


def _a(ts, locus="device_scheduling", node=2, confidence=0.5, name=None):
    return SimpleNamespace(ts=ts, locus=locus, node=node,
                           confidence=confidence,
                           primary=_f(name or "tp_straggler", node, ts))


def _c(cmd_id, ts, action="rebalance_tp", node=2, row="tp_straggler",
       term=1):
    return SimpleNamespace(cmd_id=cmd_id, ts=ts, action=action, node=node,
                           row_id=row, term=term)


def _record(P, tracer, recorder, now, **parts) -> dict:
    reps = tracer.reports()
    return {"reports": plain(reps), "counters": plain(tracer.counters),
            "orphans": [e.to_dict() for e in tracer.orphan_events],
            "problems": [P.validate_report(r) for r in reps],
            "markdown": [P.render_incident(r) for r in reps],
            "snapshot": recorder.snapshot(now),
            "window": (recorder.occupancy(), recorder.window_span()),
            "metrics": P.collect_metrics(tracer=tracer, recorder=recorder,
                                         **parts).render()}


def hook_sequence(P):
    rec = P.FlightRecorder(max_frames=5)
    tr = P.Tracer(fault_start=1.0, fault_row="tp_straggler", recorder=rec)
    tr.on_transition("dpu_crash", 0.2, "primary", lost_rows=4)
    for k in range(8):
        rec.on_batch(0.1 * k, _batch(P, 0.1 * k, kv=k % 2 == 1))
    # incident 0: detect, attribute, decide, bus with a retry, apply
    tr.on_finding(_f(ts=1.5, score=5.123456), "primary")
    tr.on_attribution(_a(1.5), "primary")
    tr.on_suppressed("cooldown", 1.6, "rebalance_tp", 2, "tp_straggler",
                     "primary")
    tr.on_command(_c(1, 2.0), "primary")
    tr.on_bus("send", _c(1, 2.0), 2.0, "primary")
    tr.on_bus("retry", _c(1, 2.0), 2.02, "primary", attempt=1)
    tr.on_bus("deliver", _c(-3, 2.0), 2.021, "primary")     # a ping
    tr.on_bus("deliver", _c(1, 2.0), 2.03, "primary")
    tr.on_transition("failover", 2.031, "watchdog")
    tr.on_apply("rebalance_tp", 2, 2.03, True, True, "engine")
    tr.on_bus("ack", _c(1, 2.0), 2.05, "primary", applied=True)
    # incident 1: stays open, a fenced and a stale command, a promotion
    for k in range(8, 12):
        rec.on_batch(0.1 * k, _batch(P, 3.0 + 0.1 * k, kv=True))
    tr.on_finding(_f("early_completion_skew", 0, 4.0, "critical", 2.0),
                  "standby")
    tr.on_attribution(_a(4.0, "scheduler", 0, 0.9,
                         "early_completion_skew"), "standby")
    tr.on_command(_c(2, 4.1, "inflight_remap", 0, "early_completion_skew",
                     term=2), "standby")
    tr.on_bus("fenced", _c(2, 4.1, "inflight_remap", 0), 4.2, "standby",
              term_now=3)
    tr.on_bus("stale", _c(3, 4.1, "inflight_remap", 0), 4.3, "standby")
    tr.on_transition("promote_standby", 4.4, "watchdog", term=3)
    tr.on_apply("inflight_remap", 0, 4.5, False, False)
    return _record(P, tr, rec, 4.6)


def traced_storm(P):
    """A sidecar under an event storm, traced: dpu_saturation is detected,
    throttle_telemetry rides the bus and lands on the host."""
    rec = P.FlightRecorder()
    tr = P.Tracer(recorder=rec)
    plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
    side = P.DPUSidecar(plane, P.DPUParams(
        events_per_s=5_000, ring_events=512,
        uplink=P.LinkParams(delay=1e-3, jitter=5e-4, duplicate_p=0.05),
        downlink=P.LinkParams(delay=1e-3, drop_p=0.2)), seed=2,
        mitigate=True)
    side.attach_tracer(tr, "primary", recorder=rec)

    class Engine:
        def apply_action(self, action, node, detail):
            tr.on_apply(action, node, side._tap_clock, True, True, "host")
            return True
    side.bind(Engine())
    for step in range(500):
        t = step * 1e-3
        side.observe_batch(_batch(P, t, n=50, kv=True))
        side.advance(t)
    assert tr.counters["applies"] >= 1
    return _record(P, tr, rec, 0.5, sidecar=side)


def traced_failover(P):
    """A watchdog over a primary that crashes and comes back, with a warm
    standby: promotion, lease grants and demotion on the trace."""
    rec = P.FlightRecorder()
    tr = P.Tracer(recorder=rec)
    plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
    side = P.DPUSidecar(plane, P.DPUParams(crash_at=0.5, restart_after=0.2),
                        mitigate=True)
    standby = P.DPUSidecar(P.TelemetryPlane(n_nodes=4, mitigate=False),
                           P.DPUParams(), mitigate=True, seed=1)
    wd = P.Watchdog(side, P.WatchdogParams(), mitigate=True,
                    standby=standby)
    wd.attach_tracer(tr, recorder=rec)
    t = 0.0
    while t < 1.5:
        wd.observe_batch(_batch(P, t, n=4, kv=True))
        wd.advance(t)
        t += 2e-3
    assert tr.counters["promotions"] == 1
    return _record(P, tr, rec, 1.5, watchdog=wd)


SCENARIOS = {f.__name__: f for f in (hook_sequence, traced_storm,
                                     traced_failover)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_obs_copy_matches_reference(scenario):
    ref, port = (SCENARIOS[scenario](_ns(pkg)) for pkg in PACKAGES)
    assert port == ref


def test_plane_metrics_match_reference():
    """collect_metrics over a plane: every line but the two sampled
    wall-clock gauges."""
    texts = []
    for pkg in PACKAGES:
        P = _ns(pkg)
        plane = P.TelemetryPlane(n_nodes=2, mitigate=False)
        for k in range(50):
            plane.observe_batch(_batch(P, k * 1e-2, kv=True))
        text = P.collect_metrics(plane=plane).render()
        texts.append([ln for ln in text.splitlines()
                      if "ns_per_event" not in ln])
    assert texts[0] == texts[1]
    assert any("repro_plane_events_total" in ln for ln in texts[1])


def test_export_renders_the_reference_tables():
    """``python -m repro_torch.core.export`` prints the reference's tables;
    only the heading names the package they were generated from."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {pkg: subprocess.run(
        [sys.executable, "-m", f"{pkg}.core.export"], check=True, env=env,
        capture_output=True, text=True, timeout=120).stdout
        for pkg in PACKAGES}
    ref, port = out["repro"], out["repro_torch"]
    assert port.splitlines()[0] == \
        "# Runbooks (generated from repro_torch.core.runbooks)"
    assert port.splitlines()[1:] == ref.splitlines()[1:]
    assert port.count("\n## Table") == 7
    assert np.all([ln.count("|") == 8 for ln in port.splitlines()
                   if ln.startswith("| ") and "`" in ln])
