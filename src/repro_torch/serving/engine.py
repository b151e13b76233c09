"""InferenceEngine: continuous-batching serving loop with the DPU-analog
telemetry plane wired through it (the paper's architecture, live).

The per-slot caches are one batched cache, e.g. ``(L, slots, kv_len, Hkv,
D)`` for a dense model's KV and ``(.., slots, H, P, N)`` for a hybrid's
Mamba2 states, with a position per slot; the decode step runs every slot in
one call, so every slot carries its own position/ring state (true continuous
batching).  Prefill attention runs in the flash kernel, decode attention in
the paged kernel, a hybrid's prefill scan in the SSD kernel (through
``Model``).  On the card an engine captures its decode step as one CUDA
graph at its first step and replays it at every later one
(``capture_step``), and likewise its prefill, one graph per prefill bucket
captured at the bucket's first prefill; elsewhere the same bodies
(``decode_body``, ``prefill_body``) run eagerly.  Telemetry taps emit the
exact event
schema the detectors consume: INGRESS on request arrival, H2D around
prefill feeds, DISPATCH per step, D2H per step, EGRESS per token,
QUEUE_SAMPLE per scheduler tick -- and the engine implements EngineControls
so the mitigation controller can close the loop (paper section 5).

Scheduling, event sizes and the simulated clock are the JAX package's,
so the reports and event batches of the two engines are equal.
"""

from __future__ import annotations

import functools
import warnings
from collections.abc import Callable, Iterable
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
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models.model import CACHE_BATCH_AXIS, reset_cache
from repro_torch.obs import EXPERT_STEPS, HOST_SPANS, FlightRecorder, Tracer
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.scheduler import (
    Scheduler,
    SchedulerConfig,
    ServeRequest,
)


def decode_body(model: Model, tokens: torch.Tensor, cache: dict,
                next_tokens: torch.Tensor) -> torch.Tensor:
    """One decode step of every row, in place: ``model.decode_step`` on
    ``tokens`` (B, 1), the new ``pos`` and ``kpos`` (an xLSTM cache has no
    ``kpos``) copied into ``cache``'s own tensors, and each row's greedy
    next token written into ``next_tokens`` (B,) int64.  Returns the logits
    (B, 1, V).  No tensor of ``cache`` is rebound or moved, so a CUDA graph
    of this body replays against the memory it was captured on."""
    logits, new = model.decode_step(tokens, cache)
    _keep_positions(cache, new)
    torch.argmax(logits[:, -1], dim=-1, out=next_tokens)
    return logits


def prefill_body(model: Model, tokens: torch.Tensor, cache: dict,
                 first: torch.Tensor) -> torch.Tensor:
    """One prompt's prefill, in place: ``cache`` (one row) reset to a fresh
    cache's values (``reset_cache``), ``model.prefill`` of ``tokens``
    (1, S) run from it as fresh (so nothing is read back), the new ``pos``
    and ``kpos`` copied into ``cache``'s own tensors, and the greedy first
    token written into ``first`` (1,) int64, which it returns.  Every
    shape depends on S alone and no tensor of ``cache`` is rebound or
    moved, so a CUDA graph of this body replays any prompt of S tokens."""
    reset_cache(cache)
    logits, new = model.prefill(tokens, cache, fresh=True)
    _keep_positions(cache, new)
    torch.argmax(logits[:, -1], dim=-1, out=first)
    return first


def _keep_positions(cache: dict, new: dict) -> None:
    """The new ``pos`` and ``kpos`` (an xLSTM cache has no ``kpos``) copied
    into ``cache``'s tensors; the stacks write every other entry in
    place."""
    for key in ("pos", "kpos"):
        if key in cache:
            cache[key].copy_(new[key])


class StepGraph:
    """``body`` captured once into ``graph`` (a ``torch.cuda.CUDAGraph``)
    inside ``capture(graph)`` (``torch.cuda.graph`` on the warm-up's
    stream), then replayed.  A capture records launches without running
    them, and a replay runs them without calling the kernels' wrappers,
    which count launches as they are called (``ops.launch_counts``): the
    counts a capture added are taken back and added again at each
    replay."""

    def __init__(self, body: Callable[[], torch.Tensor], graph,
                 capture: Callable) -> None:
        before = ops.launch_counts()
        with capture(graph):
            self.output = body()
        self.launches = {name: n - before[name]
                         for name, n in ops.launch_counts().items()
                         if n != before[name]}
        ops.add_launch_counts({name: -n for name, n in self.launches.items()})
        self.graph = graph

    def replay(self) -> torch.Tensor:
        """Launch the captured step; returns its output tensor, which every
        replay writes anew."""
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.output


def _synchronizes(fn: Callable[[], torch.Tensor]
                  ) -> tuple[torch.Tensor, bool]:
    """``fn()`` and whether it made the host wait for the device (CUDA's
    sync debugging on, in its warning mode): a graph cannot capture such a
    call, e.g. PyTorch's grouped matmul outside bf16, which reads its
    offsets back."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return out, any("called a synchronizing" in str(w.message)
                    for w in seen)


def capture_step(body: Callable[[], torch.Tensor], device: torch.device,
                 pool=None, stream: torch.cuda.Stream | None = None
                 ) -> tuple[torch.Tensor, StepGraph | None]:
    """The first run of a body on the card (the first decode step, or a
    bucket's first prefill): ``body`` run once, eagerly, on a side stream
    (a real run, and the warm-up: it allocates what a first run allocates,
    such as that stream's cuBLAS workspace and the paged kernel's
    counters), then captured on that stream, into the memory ``pool``
    (``torch.cuda.graph_pool_handle()``; None: a pool of its own).  Graphs
    that share a pool reuse each other's memory only if captured on one
    ``stream``; None makes a new one.  Returns the run's output and the
    graph, or None where the run waited for the device, which a graph
    cannot capture: that body stays eager."""
    stream = stream or torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out, waited = _synchronizes(body)
    torch.cuda.current_stream(device).wait_stream(stream)
    if waited:
        return out, None
    graph = StepGraph(body, torch.cuda.CUDAGraph(),
                      lambda g: torch.cuda.graph(g, pool=pool, stream=stream))
    return out, graph


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
        # the decode step's fixed buffers: every slot's token in; out, one
        # buffer the host reads back at once, its greedy next token and (an
        # MoE model) each MoE layer's pair count per held expert, which the
        # step writes through the cache's "expert_counts"; the step writes
        # the cache in place
        mc, slots = model.cfg, self.cfg.max_slots
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=model.device)
        self._readout = torch.zeros((slots + mc.moe_layers * mc.n_held,),
                                    dtype=torch.int64, device=model.device)
        self._next = self._readout[:slots]
        if mc.moe_layers:
            self.slot_cache["expert_counts"] = self._readout[slots:].view(
                mc.moe_layers, mc.n_held)
        # on the card: whether the first step (the capture) has run, and
        # the graph every later step replays
        self._captured = False
        self._graph: StepGraph | None = None
        # the prefill's fixed buffers: one row of cache, which each prefill
        # fills from fresh and the admitted slot's row then copies; the
        # prompt, left-padded into its bucket (a view of one buffer of the
        # longest); the greedy first token
        self._stage = model.init_cache(1, self.cfg.max_seq,
                                       self.cfg.page_size)
        self._prompt = torch.zeros(
            (max(self.sched.cfg.prefill_buckets),), dtype=torch.int32,
            device=model.device)
        self._first = torch.zeros((1,), dtype=torch.int64,
                                  device=model.device)
        # on the card: each bucket's graph, captured at its first prefill
        # (None: that prefill waited for the device, and the bucket stays
        # eager); the graphs share one memory pool, which holds nothing but
        # their scratch, and one capture stream, so that they reuse it
        self._prefills: dict[int, StepGraph | None] = {}
        self._capture_prefill = None
        if model.device.type == "cuda":
            self._capture_prefill = functools.partial(
                capture_step, device=model.device,
                pool=torch.cuda.graph_pool_handle(),
                stream=torch.cuda.Stream(model.device))
        # the last decode step's logits (B, 1, V)
        self.step_logits: torch.Tensor | None = None
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
        # host-clock span of each request waiting in the queue, by id
        self._queued: dict[int, tuple] = {}

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
        self._queued[req.req_id] = HOST_SPANS.begin(
            "request.queue", req.req_id, self.cfg.node)
        self.sched.submit(req)
        self._emit(EventKind.INGRESS_PKT, flow=req.req_id,
                   size=2 * req.prompt_len, meta=META_DIR_INGRESS)

    def _emit(self, kind: EventKind, **kw) -> None:
        if self.plane is not None:
            self._pending.add(ts=self.clock, kind=kind,
                              node=self.cfg.node, **kw)

    def _flush_telemetry(self) -> None:
        span = HOST_SPANS.open("engine.flush", -1, self.cfg.node)
        try:
            if self.plane is None:
                return
            if len(self._pending):
                batch = self._pending.build(sort=True)
                self._pending.clear()
                self._sink.observe_batch(batch)
            if self.dpu is not None:
                self.dpu.advance(self.clock)
        finally:
            HOST_SPANS.close(span)

    def _admit_loop(self) -> None:
        span = HOST_SPANS.open("engine.admit", -1, self.cfg.node)
        try:
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
                queued = self._queued.pop(req.req_id, None)
                if queued is not None:
                    HOST_SPANS.end(queued)
                self.pool.allocate(req.req_id, need)
                self._prefill(slot, req)
        finally:
            HOST_SPANS.close(span)

    def _prefill(self, slot: int, req: ServeRequest) -> None:
        spans, node = HOST_SPANS, self.cfg.node
        span = spans.open("engine.prefill", req.req_id, node)
        bucket = self.sched.bucket_len(req.prompt_len)
        toks = np.zeros((bucket,), np.int32)
        toks[-req.prompt_len:] = req.prompt    # left-pad into bucket
        # sizes count 4 bytes a token or logit, as the wire format does
        self._emit(EventKind.H2D_XFER, device=slot % 4,
                   size=int(toks.size * 4), flow=req.req_id)
        self._emit(EventKind.DISPATCH, device=slot % 4)
        enqueue = spans.open("prefill.enqueue", req.req_id, node)
        self._prompt[:bucket].copy_(torch.from_numpy(toks))
        graph = self._prefills.get(bucket)
        if graph is not None:
            replay = spans.open("prefill.replay", req.req_id, node)
            graph.replay()
            spans.close(replay)
        elif bucket in self._prefills or self._capture_prefill is None:
            self._prefill_body(bucket)
        else:
            _, self._prefills[bucket] = self._capture_prefill(
                lambda: self._prefill_body(bucket))
        spans.close(enqueue)
        # first-token logits return to the host (pairs with the dispatch)
        self._emit(EventKind.D2H_XFER, device=slot % 4,
                   size=int(self.model.cfg.vocab * 4), flow=req.req_id)
        # write the slot's row of every batched cache tensor, in place
        for key, axis in CACHE_BATCH_AXIS.items():
            if key in self._stage:
                self.slot_cache[key].select(axis, slot).copy_(
                    self._stage[key].select(axis, 0))
        wait = spans.open("prefill.wait", req.req_id, node)
        nxt = int(self._first)
        spans.close(wait)
        req.tokens_out = 0
        req.first_token = -1.0
        self._slot_next_token[slot] = nxt
        self.stats["prefills"] += 1
        spans.close(span)

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
            now = self.clock + step_time
            due = []
            while i < len(pending) and pending[i].arrival <= now:
                due.append(pending[i])
                i += 1
            self.iterate(due, step_time)
            if i >= len(pending) and not self.sched.running \
                    and not self.sched.queue:
                break
        return self.report()

    def iterate(self, arrivals: Iterable[ServeRequest] = (),
                step_time: float = 2e-3) -> None:
        """One iteration of ``run``: advance the clock by ``step_time``,
        submit ``arrivals``, sample the queue, admit (and prefill), decode
        every slot if any runs, and hand the step's events to the sink."""
        self.clock += step_time
        for req in arrivals:
            self.submit(req)
        self._emit(EventKind.QUEUE_SAMPLE,
                   depth=self.sched.queue_depth(),
                   meta=META_DIR_INGRESS)
        self._admit_loop()
        if self.sched.running:
            self._step()
        self._flush_telemetry()

    def _step(self) -> None:
        spans, node = HOST_SPANS, self.cfg.node
        span = spans.open("engine.step", -1, node)
        try:
            slots = sorted(self.sched.running)
            toks = np.zeros((self.cfg.max_slots, 1), np.int32)
            for s in slots:
                toks[s, 0] = self._slot_next_token.get(s, 0)
            self._emit(EventKind.DISPATCH, device=0)
            # every slot decodes, idle ones included, as in the JAX package
            enqueue = spans.open("step.enqueue", -1, node)
            self._tokens.copy_(torch.from_numpy(toks))
            if self._graph is not None:
                replay = spans.open("step.replay", -1, node)
                self.step_logits = self._graph.replay()
                spans.close(replay)
            elif self._tokens.is_cuda and not self._captured:
                self._captured = True
                self.step_logits, self._graph = capture_step(
                    self._decode_body, self._tokens.device)
            else:
                self.step_logits = self._decode_body()
            spans.close(enqueue)
            self._emit(EventKind.D2H_XFER, device=0,
                       size=len(slots) * 4)
            self.stats["steps"] += 1
            # the greedy tokens (and an MoE model's counts), taken on the
            # device; one copy to the host
            wait = spans.open("step.wait", -1, node)
            host = self._readout.cpu()
            spans.close(wait)
            n = self.cfg.max_slots
            if host.numel() > n:
                counts = host[n:].numpy()
                EXPERT_STEPS.book(int(counts.sum()),
                                  int(np.count_nonzero(counts)), counts.size)
            self._record_tokens(slots, host[:n].tolist())
        finally:
            spans.close(span)

    def _decode_body(self) -> torch.Tensor:
        return decode_body(self.model, self._tokens, self.slot_cache,
                           self._next)

    def _prefill_body(self, bucket: int) -> torch.Tensor:
        return prefill_body(self.model, self._prompt[:bucket].view(1, bucket),
                            self._stage, self._first)

    def _record_tokens(self, slots: list[int], nxt: list[int]) -> None:
        """The step's bookkeeping: each running slot's token counted, the
        finished ones released, their egress and a KV sample emitted."""
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
