"""The paper's primary contribution: a DPU-analog telemetry, detection,
attribution, and mitigation plane for distributed LLM inference/training.

Public surface:
  events       — DPU-observable event schema (the §4.3 boundary, enforced)
  sketch       — O(1) streaming statistics (line-rate processing)
  detectors    — 34 executable detectors, one per runbook row (the paper's
                 28 + the 3d data-parallel routing extensions + the DPU
                 self-diagnosis row + the 3e collective/rail/memory tier)
  runbooks     — Tables 3(a)/(b)/(c)/(d)/(e) as a declarative registry
  attribution  — §4.2 cross-vantage root-cause attribution
  mitigation   — §5 closed-loop controller
  telemetry    — DPUAgent / TelemetryPlane tying it together
"""

from repro_torch.core.attribution import Attribution, Attributor
from repro_torch.core.detectors import ALL_DETECTORS, Detector, DetectorConfig, Finding
from repro_torch.core.events import (
    CollectiveOp,
    Event,
    EventBatch,
    EventBatchBuilder,
    EventKind,
    EventStream,
)
from repro_torch.core.mitigation import (
    ACTIONS,
    ActionRecord,
    EngineControls,
    MitigationController,
    NullEngine,
)
from repro_torch.core.runbooks import (
    ALL_RUNBOOKS,
    BY_ID,
    BY_TABLE,
    DEFAULT_TABLES,
    RUNBOOK_3A,
    RUNBOOK_3B,
    RUNBOOK_3C,
    RUNBOOK_DPU,
    RunbookEntry,
    build_detectors,
)
from repro_torch.core.telemetry import DPUAgent, TelemetryPlane, TelemetryStats

__all__ = [
    "ACTIONS", "ALL_DETECTORS", "ALL_RUNBOOKS", "Attribution", "Attributor",
    "BY_ID", "BY_TABLE", "CollectiveOp", "DEFAULT_TABLES", "Detector",
    "DetectorConfig",
    "DPUAgent", "EngineControls", "Event", "EventBatch",
    "EventBatchBuilder", "EventKind", "EventStream",
    "Finding", "ActionRecord", "MitigationController", "NullEngine",
    "RUNBOOK_3A", "RUNBOOK_3B", "RUNBOOK_3C", "RUNBOOK_DPU", "RunbookEntry",
    "TelemetryPlane", "TelemetryStats", "build_detectors",
]
