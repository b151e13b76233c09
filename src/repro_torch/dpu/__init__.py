"""DPU-resident control plane — the paper's sidecar, modeled honestly.

Everything the repo previously did in-process (detectors polled inline,
mitigation applied the same instant an attribution appeared) moves behind a
modeled transport and a bounded compute budget here:

  transport  — one-way links with delay, jitter, and loss
  budget     — events/sec ceiling + bounded ingest ring (load shedding)
  policy     — arbitration of concurrent attributions (priority, cooldown,
               flap damping, conflict resolution)
  command    — command bus with RTT, acks, retries, backoff, stale
               invalidation, and liveness pings
  sidecar    — DPUSidecar tying tap -> budget -> detectors -> policy ->
               command bus -> host actuator (plus crash/restart chaos and
               an ingest guard over the batch sequence stream)
  watchdog   — host-side liveness supervision and degraded-mode failover
               when the sidecar itself goes dark; with a hot standby
               attached, promoted to lease arbiter (election) over a
               shadowed tap fan-out (transport.TapFanout)
  election   — leader leases with term numbers over the modeled OOB port,
               plus the fencing registry that rejects stale-term commands
               at the host actuator (split-brain guard)

``sim.cluster.run_scenario(control="dpu")`` runs the full asynchronous
loop; ``control="instant"`` preserves the legacy zero-latency topology for
golden parity.
"""

from repro_torch.dpu.budget import DPUBudget
from repro_torch.dpu.command import PING_ACTION, BusStats, CommandBus
from repro_torch.dpu.election import (
    ElectionArbiter,
    FencedCommand,
    FencingRegistry,
    LeaderLease,
    LeaseParams,
)
from repro_torch.dpu.policy import CONFLICT_GROUPS, Command, PolicyEngine
from repro_torch.dpu.sidecar import DPUParams, DPUSidecar, IngestGuard
from repro_torch.dpu.transport import LinkParams, ModeledLink, TapFanout
from repro_torch.dpu.watchdog import Watchdog, WatchdogParams

__all__ = [
    "BusStats", "CONFLICT_GROUPS", "Command", "CommandBus", "DPUBudget",
    "DPUParams", "DPUSidecar", "ElectionArbiter", "FencedCommand",
    "FencingRegistry", "IngestGuard", "LeaderLease", "LeaseParams",
    "LinkParams", "ModeledLink", "PING_ACTION", "PolicyEngine", "TapFanout",
    "Watchdog", "WatchdogParams",
]
