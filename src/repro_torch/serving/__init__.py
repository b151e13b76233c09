"""Serving substrate: paged KV accounting, continuous batching and the
telemetry-integrated inference engine."""
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServeRequest,
)
__all__ = ["EngineConfig", "InferenceEngine", "PagedKVPool", "Scheduler",
           "SchedulerConfig", "ServeRequest"]
