"""Serving substrate: paged KV accounting, continuous batching, telemetry-
integrated inference engine, and the cross-replica (data-parallel) router."""
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.router import (
    POLICIES,
    HierarchicalView,
    NodeSnapshot,
    ReplicaSet,
    ReplicaSnapshot,
    RequestInfo,
    Router,
    RouterPolicy,
    RouterView,
    RoutingDecision,
    make_policy,
)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest
__all__ = ["EngineConfig", "HierarchicalView", "InferenceEngine",
           "NodeSnapshot", "PagedKVPool", "POLICIES",
           "ReplicaSet", "ReplicaSnapshot", "RequestInfo", "Router",
           "RouterPolicy", "RouterView", "RoutingDecision", "Scheduler",
           "SchedulerConfig", "ServeRequest", "make_policy"]
