"""Observability layer: causal spans, incident flight recorder, metrics.

Everything in this package is strictly *observe-only*: attaching a
:class:`~repro_torch.obs.trace.Tracer` to the control loop draws no randomness,
mutates no events, and changes no decision — goldens are bit-identical
with tracing on or off (enforced by ``tests/test_obs.py``).  The serving
engine's host-clock spans (:mod:`repro_torch.obs.hostspans`) are
observe-only too, and always on.
"""

from repro_torch.obs.trace import (  # noqa: F401
    Incident,
    SpanEvent,
    Tracer,
    validate_report,
)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    collect_metrics,
)
from repro_torch.obs.hostspans import (  # noqa: F401
    EXPERT_STEPS,
    HOST_SPANS,
    ExpertStep,
    ExpertSteps,
    HostSpan,
    HostSpans,
    to_profiler_ns,
)
