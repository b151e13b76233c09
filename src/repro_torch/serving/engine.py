"""InferenceEngine: continuous-batching serving loop with the DPU-analog
telemetry plane wired through it (the paper's architecture, live).

The per-slot caches are one batched cache, e.g. ``(L, slots, kv_len, Hkv,
D)`` for a dense model's KV and ``(.., slots, H, P, N)`` for a hybrid's
Mamba2 states, with a position per slot; the decode step runs every slot in
one call, so every slot carries its own position/ring state (true continuous
batching).  Prefill attention runs in the flash kernel, decode attention in
the paged kernel, a hybrid's prefill scan in the SSD kernel (through
``Model``).  Telemetry taps emit the exact event
schema the detectors consume: INGRESS on request arrival, H2D around
prefill feeds, DISPATCH per step, D2H per step, EGRESS per token,
QUEUE_SAMPLE per scheduler tick -- and the engine implements EngineControls
so the mitigation controller can close the loop (paper section 5).

Scheduling, event sizes and the simulated clock are the JAX package's,
so the reports and event batches of the two engines are equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.detectors import (
    META_DIR_INGRESS,
    META_FIN,
    META_KV_OCC,
)
from repro_torch.core.events import EventBatchBuilder, EventKind
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.dpu import DPUParams, DPUSidecar
from repro_torch.models import Model
from repro_torch.models.model import CACHE_BATCH_AXIS
from repro_torch.obs import FlightRecorder, Tracer
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServeRequest,
)


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq: int = 256
    page_size: int = 16
    n_pages: int = 512
    node: int = 0
    telemetry: bool = True
    mitigate: bool = True
    greedy: bool = True
    # "instant" -- in-process MitigationController;
    # "dpu"     -- telemetry crosses a modeled transport into a DPUSidecar
    #              and mitigation commands ride the command bus back
    control: str = "instant"
    dpu: DPUParams | None = None     # sidecar parameters override
    dpu_seed: int = 0                # sidecar wire RNG (XORed with node)
    # observe-only causal tracing (repro_torch.obs): spans for every finding
    # / policy decision / bus exchange / actuation on this engine's loop
    trace: bool = False


class InferenceEngine:
    """Single-host serving engine on one device (the model's)."""

    def __init__(self, model: Model, cfg: EngineConfig | None = None,
                 plane: TelemetryPlane | None = None) -> None:
        self.model = model
        self.cfg = cfg or EngineConfig()
        self.sched = Scheduler(SchedulerConfig(max_slots=self.cfg.max_slots))
        self.pool = PagedKVPool(self.cfg.n_pages, self.cfg.page_size)
        self.plane = plane
        if self.plane is None and self.cfg.telemetry:
            self.plane = TelemetryPlane(n_nodes=1, mitigate=self.cfg.mitigate)
        # telemetry sink: the plane directly (instant) or a DPU sidecar
        # whose command bus actuates this engine (dpu)
        if self.cfg.control not in ("instant", "dpu"):
            raise ValueError(
                f"unknown EngineConfig.control {self.cfg.control!r} "
                "(expected 'instant' or 'dpu')")
        self.dpu = None
        self._sink = self.plane
        if self.plane is not None and self.cfg.control == "dpu":
            # per-replica wire seed: correlated loss across a ReplicaSet's
            # engines would be an accidental common-mode failure.  The
            # sidecar takes the plane's controller away, so the instant
            # controller is bound only in the other branch.
            self.dpu = DPUSidecar(self.plane, self.cfg.dpu, engine=self,
                                  seed=self.cfg.dpu_seed ^ self.cfg.node,
                                  mitigate=self.cfg.mitigate)
            self._sink = self.dpu
        elif self.plane is not None and self.plane.controller is not None:
            self.plane.controller.engine = self
        # observability (observe-only; engine runs have no FaultSpec, so
        # incidents open on the first finding and never auto-close)
        self.tracer = None
        self.recorder = None
        if self.cfg.trace and self.plane is not None:
            self.recorder = FlightRecorder()
            self.tracer = Tracer(recorder=self.recorder)
            if self.dpu is not None:
                self.dpu.attach_tracer(self.tracer, "primary",
                                       recorder=self.recorder)
            else:
                self.plane.tracer = self.tracer
                self.plane.trace_source = "engine"
                self.plane.recorder = self.recorder
        self.slot_cache = model.init_cache(self.cfg.max_slots,
                                           self.cfg.max_seq,
                                           self.cfg.page_size)
        self.clock = 0.0
        self.completed: list[ServeRequest] = []
        self.kv_compress = False
        # telemetry back-pressure knob: emit low-priority samples (KV
        # occupancy) every Nth step; throttle_telemetry doubles the stride
        self.telemetry_stride = 1
        self.stats = {"steps": 0, "tokens": 0, "prefills": 0}
        # telemetry taps accumulate columnar rows; one batch per step goes
        # to the plane (the engine feeds the same line-rate path as the sim)
        self._pending = EventBatchBuilder()
        self._slot_next_token: dict[int, int] = {}

    # ------------------------------------------------------------------
    # EngineControls (mitigation actuation surface)
    # ------------------------------------------------------------------

    def apply_action(self, action: str, node: int, detail: dict) -> bool:
        if self.tracer is not None:
            # the live engine has no fault oracle, so no recovery flip --
            # the apply is recorded on the open incident's span tree
            self.tracer.on_apply(action, node, self.clock, False, False,
                                 "engine")
        if action == "inflight_remap":
            self.sched.set_continuous(True)
            return True
        if action == "widen_batch_window":
            self.sched.set_batch_window(
                max(self.sched.cfg.batch_window * 2, 2e-3))
            return True
        if action == "admission_control":
            self.sched.pause_admission(self.clock + 0.05)
            return True
        if action == "smooth_admission":
            self.sched.set_batch_window(
                max(self.sched.cfg.batch_window, 1e-3))
            return True
        if action == "compress_kv":
            self.kv_compress = True
            return True
        if action == "throttle_telemetry":
            self.telemetry_stride = min(self.telemetry_stride * 2, 64)
            return True
        if action in ("rebalance_microbatches", "rebalance_shards",
                      "rebalance_frontend", "pin_and_coalesce",
                      "batch_launches"):
            return True     # accepted; no-op at single-host scale
        return False

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        self.sched.submit(req)
        self._emit(EventKind.INGRESS_PKT, flow=req.req_id,
                   size=2 * req.prompt_len, meta=META_DIR_INGRESS)

    def _emit(self, kind: EventKind, **kw) -> None:
        if self.plane is not None:
            self._pending.add(ts=self.clock, kind=kind,
                              node=self.cfg.node, **kw)

    def _flush_telemetry(self) -> None:
        if self.plane is None:
            return
        if len(self._pending):
            batch = self._pending.build(sort=True)
            self._pending.clear()
            self._sink.observe_batch(batch)
        if self.dpu is not None:
            self.dpu.advance(self.clock)

    def _admit_loop(self) -> None:
        while True:
            if not self.sched.queue:
                break
            head = self.sched.queue[0]
            need = head.prompt_len + head.max_new_tokens
            if not self.pool.can_admit(need):
                # paper section 5: early KV eviction under pressure
                if self.pool.evict_lru() is None:
                    break
                continue
            got = self.sched.admit(self.clock)
            if got is None:
                break
            slot, req = got
            self.pool.allocate(req.req_id, need)
            self._prefill(slot, req)

    def _prefill(self, slot: int, req: ServeRequest) -> None:
        bucket = self.sched.bucket_len(req.prompt_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, -req.prompt_len:] = req.prompt    # left-pad into bucket
        # sizes count 4 bytes a token or logit, as the wire format does
        self._emit(EventKind.H2D_XFER, device=slot % 4,
                   size=int(toks.size * 4), flow=req.req_id)
        fresh = self.model.init_cache(1, self.cfg.max_seq,
                                      self.cfg.page_size)
        self._emit(EventKind.DISPATCH, device=slot % 4)
        logits, cache = self.model.prefill(
            torch.from_numpy(toks).to(self.model.device), fresh)
        # first-token logits return to the host (pairs with the dispatch)
        self._emit(EventKind.D2H_XFER, device=slot % 4,
                   size=int(logits.numel() * 4), flow=req.req_id)
        # write the slot's row of every batched cache tensor, in place
        for key, axis in CACHE_BATCH_AXIS.items():
            if key in cache:
                self.slot_cache[key].select(axis, slot).copy_(
                    cache[key].select(axis, 0))
        nxt = int(torch.argmax(logits[0, -1]))
        req.tokens_out = 0
        req.first_token = -1.0
        self._slot_next_token[slot] = nxt
        self.stats["prefills"] += 1

    # ------------------------------------------------------------------
    # decode loop
    # ------------------------------------------------------------------

    def run(self, requests: list[ServeRequest], max_steps: int = 2000,
            step_time: float = 2e-3) -> dict:
        """Drive the engine until all requests finish (or step budget)."""
        self._slot_next_token = {}
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        for step in range(max_steps):
            self.clock += step_time
            while i < len(pending) and pending[i].arrival <= self.clock:
                self.submit(pending[i])
                i += 1
            self._emit(EventKind.QUEUE_SAMPLE,
                       depth=self.sched.queue_depth(),
                       meta=META_DIR_INGRESS)
            self._admit_loop()
            if self.sched.running:
                self._step()
            self._flush_telemetry()
            if i >= len(pending) and not self.sched.running \
                    and not self.sched.queue:
                break
        return self.report()

    def _step(self) -> None:
        slots = sorted(self.sched.running)
        toks = np.zeros((self.cfg.max_slots, 1), np.int32)
        for s in slots:
            toks[s, 0] = self._slot_next_token.get(s, 0)
        self._emit(EventKind.DISPATCH, device=0)
        # every slot decodes, idle ones included, as in the JAX package
        logits, self.slot_cache = self.model.decode_step(
            torch.from_numpy(toks).to(self.model.device), self.slot_cache)
        self._emit(EventKind.D2H_XFER, device=0,
                   size=len(slots) * 4)
        self.stats["steps"] += 1
        # greedy argmax on the device; one copy to the host per step
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        eg_flow: list[int] = []
        eg_meta: list[int] = []
        for s in slots:
            req = self.sched.running[s]
            if req.first_token < 0:
                req.first_token = self.clock
            req.tokens_out += 1
            self.stats["tokens"] += 1
            self.pool.extend(req.req_id)
            self._slot_next_token[s] = int(nxt[s])
            fin = req.tokens_out >= req.max_new_tokens
            eg_flow.append(req.req_id)
            eg_meta.append(META_FIN if fin else 0)
            if fin:
                self.sched.release(s, self.clock)
                self.pool.free(req.req_id)
                self.completed.append(req)
        # token egress leaves as one columnar append per step (the same
        # bulk path the simulator's producer plane uses)
        if self.plane is not None and eg_flow:
            self._pending.add_columns(
                np.full(len(eg_flow), self.clock), EventKind.EGRESS_PKT,
                node=self.cfg.node,
                flow=np.asarray(eg_flow, np.int64),
                size=8 if not self.kv_compress else 4,
                group=self.cfg.node,
                meta=np.asarray(eg_meta, np.int64))
        # KV occupancy sample (Table 2b) -- the low-priority event class the
        # throttle_telemetry actuation strides down
        if self.stats["steps"] % self.telemetry_stride == 0:
            self._emit(EventKind.QUEUE_SAMPLE,
                       depth=int(self.pool.occupancy() * 100),
                       meta=META_KV_OCC)

    # ------------------------------------------------------------------

    def report(self) -> dict:
        self._flush_telemetry()
        lats = sorted(r.latency for r in self.completed)
        ttfts = sorted(r.ttft for r in self.completed)

        def pct(xs, q):
            return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else None
        rep = {
            "completed": len(self.completed),
            "steps": self.stats["steps"],
            "tokens": self.stats["tokens"],
            "tokens_per_step": self.stats["tokens"]
            / max(self.stats["steps"], 1),
            "p50_latency": pct(lats, 0.5),
            "p99_latency": pct(lats, 0.99),
            "p50_ttft": pct(ttfts, 0.5),
            "kv_occupancy": self.pool.occupancy(),
            "evictions": self.pool.stats.evictions,
        }
        if self.plane is not None:
            rep["telemetry"] = self.plane.report()
        return rep
