"""Metrics exposition: counters/gauges/histograms in Prometheus text.

Hand-rolled (no prometheus_client dependency): the repo only needs the
text exposition format, which is trivially a sorted dump of
``name{labels} value`` lines.  ``collect_metrics`` walks a finished
run (tracer + plane/sidecar/watchdog stats) and populates a registry;
callers render it with :meth:`MetricsRegistry.render`.
"""

from __future__ import annotations

from typing import Any

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "collect_metrics"]


def _fmt_labels(labels: dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self._vals: dict[tuple[tuple[str, Any], ...], float] = {}

    def _key(self, labels: dict[str, Any]) -> tuple[tuple[str, Any], ...]:
        return tuple(sorted(labels.items()))

    def samples(self) -> list[tuple[str, str, float]]:
        return [(self.name, _fmt_labels(dict(k)), v)
                for k, v in sorted(self._vals.items())]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        k = self._key(labels)
        self._vals[k] = self._vals.get(k, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._vals[self._key(labels)] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...]) -> None:
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._obs: dict[tuple[tuple[str, Any], ...],
                        tuple[list[int], float, int]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        k = self._key(labels)
        counts, total, n = self._obs.get(
            k, ([0] * len(self.buckets), 0.0, 0))
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
        self._obs[k] = (counts, total + value, n + 1)

    def samples(self) -> list[tuple[str, str, float]]:
        out: list[tuple[str, str, float]] = []
        for k, (counts, total, n) in sorted(self._obs.items()):
            base = dict(k)
            for i, ub in enumerate(self.buckets):
                lbl = dict(base)
                lbl["le"] = f"{ub:g}"
                out.append((self.name + "_bucket", _fmt_labels(lbl),
                            float(counts[i])))
            inf = dict(base)
            inf["le"] = "+Inf"
            out.append((self.name + "_bucket", _fmt_labels(inf), float(n)))
            out.append((self.name + "_sum", _fmt_labels(base), total))
            out.append((self.name + "_count", _fmt_labels(base), float(n)))
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple[float, ...] = (
                      0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
                  ) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_text, buckets))

    def _get(self, name: str, factory: Any) -> Any:
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        return m

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample_name, labels, value in m.samples():
                if value == int(value):
                    lines.append(f"{sample_name}{labels} {int(value)}")
                else:
                    lines.append(f"{sample_name}{labels} {value:.9g}")
        return "\n".join(lines) + "\n"


def collect_metrics(tracer: Any = None, plane: Any = None,
                    sidecar: Any = None, watchdog: Any = None,
                    recorder: Any = None,
                    registry: MetricsRegistry | None = None,
                    ) -> MetricsRegistry:
    """Populate a registry from a finished run's components.

    Every argument is optional — pass whatever the run had.  Pure
    post-hoc aggregation: nothing here touches the hot path.
    """
    reg = registry if registry is not None else MetricsRegistry()

    if tracer is not None:
        c = tracer.counters
        findings = reg.counter(
            "repro_findings_total", "Detector findings by runbook row")
        for row, n in sorted(c["findings_by_row"].items()):
            findings.inc(n, row=row)
        bus = reg.counter(
            "repro_bus_events_total", "Command-bus lifecycle events")
        for ev in ("send", "retry", "deliver", "ack", "fenced", "stale",
                   "expired"):
            if c.get("bus_" + ev):
                bus.inc(c["bus_" + ev], event=ev)
        if c["bus_fenced"]:
            reg.counter(
                "repro_commands_fenced_total",
                "Stale-term commands rejected at the host actuator",
            ).inc(c["bus_fenced"])
        ctl = reg.counter(
            "repro_control_transitions_total",
            "Watchdog / election control-plane transitions")
        for kind in ("failovers", "failbacks", "promotions", "demotions",
                     "crashes", "lease_grants"):
            if c.get(kind):
                ctl.inc(c[kind], kind=kind)
        reg.gauge("repro_incidents_open",
                  "Incidents currently open").set(
            1.0 if tracer.current is not None else 0.0)
        if tracer.incidents:
            reg.counter("repro_incidents_total",
                        "Incidents opened").inc(len(tracer.incidents))
        ttm_h = reg.histogram(
            "repro_ttm_seconds", "Per-phase time-to-mitigate",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0))
        for inc in tracer.incidents:
            ttm = inc.ttm()
            for phase, v in ttm.items():
                if v is not None:
                    ttm_h.observe(v, phase=phase)

    if plane is not None:
        st = plane.stats
        reg.gauge("repro_plane_events_total",
                  "Events observed by the telemetry plane").set(st.events)
        reg.gauge("repro_detector_ns_per_event",
                  "Sampled plane-wide detector cost").set(
            st.ns_per_event())
        per_det = getattr(st, "ns_per_event_by_detector", None)
        if per_det is not None:
            g = reg.gauge(
                "repro_detector_family_ns_per_event",
                "Sampled per-detector-family cost (same every-Nth "
                "cadence as the plane-wide figure)")
            for name, ns in sorted(per_det().items()):
                g.set(ns, detector=name)

    if sidecar is not None:
        rep = sidecar.report() if hasattr(sidecar, "report") else {}
        g = reg.gauge("repro_dpu_sidecar", "DPU sidecar health scalars")
        for key in ("dropped_events", "deferred_events", "overload_s"):
            if key in rep:
                g.set(rep[key], field=key)

    if watchdog is not None:
        rep = watchdog.report() if hasattr(watchdog, "report") else {}
        # Watchdog.report() nests its scalars under a "watchdog" key
        if isinstance(rep.get("watchdog"), dict):
            rep = rep["watchdog"]
        g = reg.gauge("repro_watchdog", "Watchdog state scalars")
        for key, val in rep.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                g.set(val, field=key)

    if recorder is not None:
        reg.gauge("repro_flight_recorder_frames",
                  "Flight-recorder ring occupancy").set(
            recorder.occupancy())
        reg.gauge("repro_flight_recorder_window_seconds",
                  "Event-time span covered by the ring").set(
            recorder.window_span())

    return reg
