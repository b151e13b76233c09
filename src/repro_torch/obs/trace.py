"""Causal control-loop tracing: incidents, spans, and TTM decomposition.

A :class:`Tracer` rides along the closed mitigation loop as a passive
observer.  The first finding a detector emits *opens* an incident (one
trace context per fault episode); every later finding, attribution,
policy decision, bus command/ack/retry/fencing event, watchdog
transition, and actuator application attaches to that open incident.
The apply that flips the fault's ``mitigated`` flag *closes* it.

Because every hook receives a timestamp already flowing through the
loop (batch event time, poll time, or the host round clock — all one
virtual timeline), the tracer needs no clock of its own, draws zero
randomness, and never mutates an event: runs are bit-identical with
tracing on or off.

Time-to-mitigate decomposes into telescoping phases::

    fault_start --t_detect--> detected --t_attribute--> attributed
        --t_decide--> decided --t_bus_rtt--> applied --t_apply-->
        recovered

``decided`` is the issue timestamp of the command that ultimately
recovered the fault, so ``t_bus_rtt`` absorbs queueing, the modeled
down-link, and any retries.  Paths that bypass the bus (instant
control, degraded host fallback) telescope ``decided == applied`` and
report ``t_bus_rtt == 0`` — which is exactly what makes the chaos
lane's hot-vs-degraded gap attributable to named phases.  The phases
always sum to ``recovered - fault_start``, i.e. the existing
``t_recover`` scalar.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "SpanEvent",
    "Incident",
    "Tracer",
    "validate_report",
    "REPORT_VERSION",
]

REPORT_VERSION = 1

# Phases, in causal order.  Used for span-tree grouping and validation.
PHASES = ("detect", "attribute", "decide", "bus", "apply", "control",
          "recover")

# Hard cap on retained span events per incident so a never-mitigated
# sweep run cannot grow without bound; overflow is counted, not silent.
MAX_EVENTS_PER_INCIDENT = 2048


class SpanEvent:
    """One timestamped occurrence inside an incident's span tree."""

    __slots__ = ("ts", "phase", "name", "source", "detail")

    def __init__(self, ts: float, phase: str, name: str, source: str,
                 detail: dict[str, Any] | None = None) -> None:
        self.ts = ts
        self.phase = phase
        self.name = name
        self.source = source
        self.detail = detail or {}

    def to_dict(self) -> dict[str, Any]:
        return {"ts": round(self.ts, 6), "phase": self.phase,
                "name": self.name, "source": self.source,
                "detail": self.detail}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanEvent({self.ts:.3f}, {self.phase}/{self.name}"
                f" @{self.source})")


class Incident:
    """One fault episode: a trace context plus its span events."""

    __slots__ = (
        "incident_id", "row", "opened_ts", "fault_start", "fault_row",
        "events", "dropped_events", "closed",
        "detected_ts", "attributed_ts", "decided_ts", "applied_ts",
        "recovered_ts", "recover_cmd_id", "recover_action",
        "telemetry_snapshot",
    )

    def __init__(self, incident_id: str, row: str, opened_ts: float,
                 fault_start: float | None, fault_row: str | None) -> None:
        self.incident_id = incident_id
        self.row = row
        self.opened_ts = opened_ts
        self.fault_start = fault_start
        self.fault_row = fault_row
        self.events: list[SpanEvent] = []
        self.dropped_events = 0
        self.closed = False
        # TTM milestones (virtual-clock seconds); None = not reached.
        self.detected_ts: float | None = opened_ts
        self.attributed_ts: float | None = None
        self.decided_ts: float | None = None
        self.applied_ts: float | None = None
        self.recovered_ts: float | None = None
        self.recover_cmd_id: int | None = None
        self.recover_action: str | None = None
        self.telemetry_snapshot: dict[str, Any] | None = None

    # -- recording -------------------------------------------------------

    def add(self, ts: float, phase: str, name: str, source: str,
            detail: dict[str, Any] | None = None) -> None:
        if len(self.events) >= MAX_EVENTS_PER_INCIDENT:
            self.dropped_events += 1
            return
        self.events.append(SpanEvent(ts, phase, name, source, detail))

    # -- TTM decomposition ----------------------------------------------

    def milestones(self) -> dict[str, float | None]:
        return {
            "fault_start": self.fault_start,
            "detected": self.detected_ts,
            "attributed": self.attributed_ts,
            "decided": self.decided_ts,
            "applied": self.applied_ts,
            "recovered": self.recovered_ts,
        }

    def ttm(self) -> dict[str, float | None]:
        """Telescoped phase durations; present phases sum to t_recover.

        Unreached milestones inherit their predecessor (a path that
        skipped the bus contributes 0 to ``t_bus_rtt``, not a gap), so
        whenever ``recovered`` is known the six phases sum *exactly*
        to ``recovered - fault_start``.
        """
        start = self.fault_start
        detected = self.detected_ts
        if start is None or detected is None:
            return {k: None for k in ("t_detect", "t_attribute", "t_decide",
                                      "t_bus_rtt", "t_apply", "t_recover")}
        attributed = self.attributed_ts if self.attributed_ts is not None \
            else detected
        decided = self.decided_ts if self.decided_ts is not None \
            else (self.applied_ts if self.applied_ts is not None
                  else attributed)
        applied = self.applied_ts if self.applied_ts is not None else decided
        recovered = self.recovered_ts
        out: dict[str, float | None] = {
            "t_detect": detected - start,
            "t_attribute": attributed - detected,
            "t_decide": decided - attributed,
            "t_bus_rtt": applied - decided,
            "t_apply": (recovered - applied) if recovered is not None
            else None,
            "t_recover": (recovered - start) if recovered is not None
            else None,
        }
        return out

    # -- export ----------------------------------------------------------

    def span_tree(self) -> dict[str, Any]:
        """Group the flat event list into a per-phase span tree.

        Bus events are further grouped per command id so a retried or
        fenced command reads as one child span with its full lifecycle.
        """
        by_phase: dict[str, list[SpanEvent]] = {p: [] for p in PHASES}
        for ev in self.events:
            by_phase.setdefault(ev.phase, []).append(ev)
        children: list[dict[str, Any]] = []
        for phase in by_phase:
            evs = by_phase[phase]
            if not evs:
                continue
            node: dict[str, Any] = {
                "name": phase,
                "start_ts": round(min(e.ts for e in evs), 6),
                "end_ts": round(max(e.ts for e in evs), 6),
                "events": [],
                "children": [],
            }
            if phase == "bus":
                by_cmd: dict[int, list[SpanEvent]] = {}
                loose: list[SpanEvent] = []
                for e in evs:
                    cid = e.detail.get("cmd_id")
                    if cid is None:
                        loose.append(e)
                    else:
                        by_cmd.setdefault(cid, []).append(e)
                node["events"] = [e.to_dict() for e in loose]
                for cid in sorted(by_cmd):
                    ce = by_cmd[cid]
                    node["children"].append({
                        "name": f"cmd-{cid} "
                                f"{ce[0].detail.get('action', '?')}",
                        "start_ts": round(min(e.ts for e in ce), 6),
                        "end_ts": round(max(e.ts for e in ce), 6),
                        "events": [e.to_dict() for e in ce],
                        "children": [],
                    })
            else:
                node["events"] = [e.to_dict() for e in evs]
            children.append(node)
        return {
            "name": f"incident {self.incident_id} ({self.row})",
            "start_ts": round(self.opened_ts, 6),
            "end_ts": round(self.recovered_ts, 6)
            if self.recovered_ts is not None
            else (round(self.events[-1].ts, 6) if self.events
                  else round(self.opened_ts, 6)),
            "events": [],
            "children": children,
        }

    def to_report(self) -> dict[str, Any]:
        return {
            "version": REPORT_VERSION,
            "incident_id": self.incident_id,
            "row": self.row,
            "fault_row": self.fault_row,
            "opened_ts": round(self.opened_ts, 6),
            "fault_start": self.fault_start,
            "closed": self.closed,
            "recover_action": self.recover_action,
            "milestones": {
                k: (round(v, 6) if v is not None else None)
                for k, v in self.milestones().items()
            },
            "ttm": {
                k: (round(v, 6) if v is not None else None)
                for k, v in self.ttm().items()
            },
            "timeline": [e.to_dict() for e in self.events],
            "dropped_events": self.dropped_events,
            "span_tree": self.span_tree(),
            "telemetry": self.telemetry_snapshot,
        }


class Tracer:
    """Passive observer threaded through plane, policy, bus, and host.

    Components hold a ``tracer`` attribute (``None`` by default); every
    hook site is guarded by ``if self.tracer is not None`` so the
    disabled path costs one attribute load.  All hooks are observe-only.
    """

    def __init__(self, fault_start: float | None = None,
                 fault_row: str | None = None,
                 recorder: Any = None) -> None:
        self.fault_start = fault_start
        self.fault_row = fault_row
        self.recorder = recorder
        self.incidents: list[Incident] = []
        self._current: Incident | None = None
        # cmd_id -> (issue_ts, action, node, incident) for correlating
        # bus lifecycle events back to the incident that caused them.
        self._cmds: dict[int, tuple[float, str, int, Incident]] = {}
        # Last bus delivery, so the synchronous apply that follows can
        # attribute its decided_ts to the command's issue time.
        self._last_deliver: tuple[int, str, int, float] | None = None
        # Control-plane events with no open incident (e.g. a chaos
        # schedule crashing the DPU before any finding) land here.
        self.orphan_events: list[SpanEvent] = []
        self.counters: dict[str, Any] = {
            "findings": 0,
            "findings_by_row": {},
            "attributions": 0,
            "commands": 0,
            "suppressed": 0,
            "bus_send": 0,
            "bus_retry": 0,
            "bus_deliver": 0,
            "bus_ack": 0,
            "bus_fenced": 0,
            "bus_stale": 0,
            "bus_expired": 0,
            "applies": 0,
            "failovers": 0,
            "failbacks": 0,
            "promotions": 0,
            "demotions": 0,
            "crashes": 0,
            "lease_grants": 0,
        }

    # -- incident lifecycle ---------------------------------------------

    @property
    def current(self) -> Incident | None:
        return self._current

    def _open(self, row: str, ts: float) -> Incident:
        inc = Incident(
            incident_id=f"inc-{len(self.incidents):03d}",
            row=row, opened_ts=ts,
            fault_start=self.fault_start, fault_row=self.fault_row)
        if self.recorder is not None:
            inc.telemetry_snapshot = self.recorder.snapshot(ts)
        self.incidents.append(inc)
        self._current = inc
        return inc

    # -- hooks: detection / attribution ---------------------------------

    def on_finding(self, f: Any, source: str = "") -> None:
        c = self.counters
        c["findings"] += 1
        c["findings_by_row"][f.name] = \
            c["findings_by_row"].get(f.name, 0) + 1
        inc = self._current
        if inc is None:
            inc = self._open(f.name, f.ts)
        inc.add(f.ts, "detect", f.name, source,
                {"node": f.node, "severity": f.severity,
                 "score": round(f.score, 4)})

    def on_attribution(self, a: Any, source: str = "") -> None:
        self.counters["attributions"] += 1
        inc = self._current
        if inc is None:
            return
        if inc.attributed_ts is None:
            inc.attributed_ts = a.ts
        inc.add(a.ts, "attribute", a.locus, source,
                {"node": a.node, "confidence": a.confidence,
                 "primary": a.primary.name})

    # -- hooks: policy ---------------------------------------------------

    def on_command(self, cmd: Any, source: str = "") -> None:
        self.counters["commands"] += 1
        inc = self._current
        if inc is None:
            return
        self._cmds[cmd.cmd_id] = (cmd.ts, cmd.action, cmd.node, inc)
        inc.add(cmd.ts, "decide", cmd.action, source,
                {"cmd_id": cmd.cmd_id, "node": cmd.node,
                 "row": cmd.row_id, "term": cmd.term})

    def on_suppressed(self, reason: str, now: float, action: str,
                      node: int, row: str, source: str = "") -> None:
        self.counters["suppressed"] += 1
        inc = self._current
        if inc is None:
            return
        inc.add(now, "decide", f"suppressed:{reason}", source,
                {"action": action, "node": node, "row": row})

    # -- hooks: command bus ---------------------------------------------

    def on_bus(self, event: str, cmd: Any, now: float, source: str = "",
               **detail: Any) -> None:
        if cmd.cmd_id < 0:  # liveness pings are not causal traffic
            return
        key = "bus_" + event
        if key in self.counters:
            self.counters[key] += 1
        entry = self._cmds.get(cmd.cmd_id)
        inc = entry[3] if entry is not None else self._current
        if event == "deliver":
            self._last_deliver = (cmd.cmd_id, cmd.action, cmd.node, now)
        if inc is None:
            return
        d: dict[str, Any] = {"cmd_id": cmd.cmd_id, "action": cmd.action,
                             "node": cmd.node, "term": cmd.term}
        d.update(detail)
        inc.add(now, "bus", event, source, d)

    # -- hooks: actuator -------------------------------------------------

    def on_apply(self, action: str, node: int, now: float,
                 matched: bool, newly_recovered: bool,
                 source: str = "host") -> None:
        self.counters["applies"] += 1
        inc = self._current
        if inc is None:
            return
        inc.add(now, "apply", action, source,
                {"node": node, "matched": matched})
        if not newly_recovered:
            return
        inc.applied_ts = now
        inc.recovered_ts = now
        inc.recover_action = action
        ld = self._last_deliver
        if ld is not None and ld[1] == action and ld[2] == node \
                and ld[3] == now:
            inc.recover_cmd_id = ld[0]
            entry = self._cmds.get(ld[0])
            if entry is not None:
                inc.decided_ts = entry[0]
        inc.add(now, "recover", "mitigated", source,
                {"action": action, "node": node,
                 "cmd_id": inc.recover_cmd_id})
        inc.closed = True
        self._current = None

    # -- hooks: control-plane transitions -------------------------------

    def on_transition(self, name: str, now: float, source: str = "",
                      **detail: Any) -> None:
        key = {"failover": "failovers", "failback": "failbacks",
               "promote_standby": "promotions",
               "demote_standby": "demotions",
               "dpu_crash": "crashes", "dpu_restart": "crashes",
               "lease_grant": "lease_grants"}.get(name)
        if key is not None and name != "dpu_restart":
            self.counters[key] += 1
        inc = self._current
        if inc is not None:
            inc.add(now, "control", name, source, dict(detail))
        elif len(self.orphan_events) < MAX_EVENTS_PER_INCIDENT:
            self.orphan_events.append(
                SpanEvent(now, "control", name, source, dict(detail)))

    # -- export ----------------------------------------------------------

    def reports(self) -> list[dict[str, Any]]:
        return [inc.to_report() for inc in self.incidents]


# -- incident report schema ---------------------------------------------

_REQUIRED: dict[str, type | tuple[type, ...]] = {
    "version": int,
    "incident_id": str,
    "row": str,
    "opened_ts": (int, float),
    "closed": bool,
    "milestones": dict,
    "ttm": dict,
    "timeline": list,
    "span_tree": dict,
}

_TTM_KEYS = ("t_detect", "t_attribute", "t_decide", "t_bus_rtt",
             "t_apply", "t_recover")


def validate_report(report: Any) -> list[str]:
    """Structural check of an incident report; returns a list of
    problems (empty == valid).  Hand-rolled so the repo needs no
    jsonschema dependency."""
    errs: list[str] = []
    if not isinstance(report, dict):
        return ["report is not a dict"]
    for key, typ in _REQUIRED.items():
        if key not in report:
            errs.append(f"missing key: {key}")
        elif not isinstance(report[key], typ):
            errs.append(f"bad type for {key}: {type(report[key]).__name__}")
    if errs:
        return errs
    if report["version"] != REPORT_VERSION:
        errs.append(f"unknown report version {report['version']}")
    for k in _TTM_KEYS:
        if k not in report["ttm"]:
            errs.append(f"ttm missing {k}")
        elif report["ttm"][k] is not None \
                and not isinstance(report["ttm"][k], (int, float)):
            errs.append(f"ttm[{k}] not numeric")
    for i, ev in enumerate(report["timeline"]):
        if not isinstance(ev, dict):
            errs.append(f"timeline[{i}] not a dict")
            continue
        for k in ("ts", "phase", "name", "source"):
            if k not in ev:
                errs.append(f"timeline[{i}] missing {k}")
        if "phase" in ev and ev["phase"] not in PHASES:
            errs.append(f"timeline[{i}] unknown phase {ev['phase']!r}")
    tree = report["span_tree"]
    for k in ("name", "children"):
        if k not in tree:
            errs.append(f"span_tree missing {k}")
    ttm = report["ttm"]
    if ttm.get("t_recover") is not None:
        phases = [ttm.get(k) for k in _TTM_KEYS[:-1]]
        if any(not isinstance(p, (int, float)) for p in phases):
            errs.append("ttm has t_recover but a phase is missing")
        else:
            total = sum(phases)
            # tolerance absorbs per-phase 1e-6 export rounding only
            if abs(total - ttm["t_recover"]) > 1e-4:
                errs.append(
                    f"ttm phases sum {total:.6f} != t_recover "
                    f"{ttm['t_recover']:.6f}")
    return errs
