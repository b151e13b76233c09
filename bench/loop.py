"""Drive ``repro_torch``'s ``InferenceEngine`` as a closed loop.

One iteration is the body of ``InferenceEngine.run``, in its order: the
engine's clock advances by ``step_time``; the clients' pending requests are
submitted; the QUEUE_SAMPLE event is emitted; ``_admit_loop`` admits and
prefills; ``_step`` decodes every slot; ``_flush_telemetry`` hands the
step's events to the DPU sidecar.  The engine has no public per-iteration
entry, so these methods are called directly.  Telemetry, detections and
mitigations then follow the engine's clock, the same on every host; the
host clock is read only for the metrics.

A client whose request finished in a step submits its next one at the start
of the next iteration (no think time).  Each token is stamped when the step
that emitted it returns; the first token of a request is the one its first
step emits (the engine's ``first_token``).  ``Loop`` keeps the host spans
of each phase (``submit``, ``admit``, ``prefill`` inside it, ``decode_step``,
``telemetry_flush``) and the shapes of every kernel call it drives."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.traffic import ClosedLoop, Request


@dataclass
class Iteration:
    t0: float
    t1: float = 0.0
    prefills: list = field(default_factory=list)  # (bucket, prompt_len, s)
    running: int = 0           # slots that emitted a token in the step
    context: int = 0           # real positions those tokens attended, summed
    lengths: int = 0           # cached positions the paged kernel read
    step_s: float = 0.0
    flush_s: float = 0.0


class Loop:
    def __init__(self, engine, mix: dict, vocab: int, seed: int,
                 annotate: bool = False) -> None:
        from repro_torch.core.detectors import META_DIR_INGRESS
        from repro_torch.core.events import EventKind
        from repro_torch.serving.scheduler import ServeRequest
        self._queue_sample = (EventKind.QUEUE_SAMPLE, META_DIR_INGRESS)
        self._serve_request = ServeRequest
        self.engine = engine
        self.mix = mix
        self.step_time = mix["step_time"]
        self.traffic = ClosedLoop(mix, vocab, seed)
        self.requests: dict[int, Request] = {}
        self.pending = [self.traffic.first(c) for c in range(mix["clients"])]
        self.iterations: list[Iteration] = []
        self.kv_len = engine.cfg.max_seq
        self.pos = np.zeros(engine.cfg.max_slots, np.int64)
        self.annotate = annotate
        self._cur: Iteration | None = None
        prefill = engine._prefill

        def timed_prefill(slot, sreq):
            s = time.perf_counter()
            with self._span("prefill"):
                prefill(slot, sreq)
            req = self.requests[sreq.req_id]
            req.bucket = engine.sched.bucket_len(sreq.prompt_len)
            req.tokens.append(int(engine._slot_next_token[slot]))
            self.pos[slot] = req.bucket
            self._cur.prefills.append((req.bucket, sreq.prompt_len,
                                       time.perf_counter() - s))
        engine._prefill = timed_prefill
        # the mitigations the DPU's commands apply, by loop iteration
        self.actions: list[tuple[int, str]] = []
        apply = engine.apply_action

        def recorded_apply(action, node, detail):
            self.actions.append((len(self.iterations), action))
            return apply(action, node, detail)
        engine.apply_action = recorded_apply

    def _span(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def iterate(self) -> Iteration:
        eng = self.engine
        it = self._cur = Iteration(time.perf_counter())
        eng.clock += self.step_time
        with self._span("submit"):
            for req in self.pending:
                self.requests[req.rid] = req
                eng.submit(self._serve_request(
                    req.rid, eng.clock, req.prompt.tolist(), req.max_new))
                req.submitted = time.perf_counter()
            self.pending = []
            kind, meta = self._queue_sample
            eng._emit(kind, depth=eng.sched.queue_depth(), meta=meta)
        with self._span("admit"):
            eng._admit_loop()
        if eng.sched.running:
            before = dict(eng.sched.running)
            lengths = int(np.minimum(self.pos + 1, self.kv_len).sum())
            s = time.perf_counter()
            with self._span("decode_step"):
                eng._step()
            now = time.perf_counter()
            it.step_s = now - s
            it.lengths = lengths
            self.pos += 1
            it.running = len(before)
            for slot, sreq in before.items():
                req = self.requests[sreq.req_id]
                it.context += sreq.prompt_len + len(req.tokens)
                req.tokens.append(int(eng._slot_next_token[slot]))
                req.stamps.append(now)
                if req.first < 0:
                    req.first = now
                if sreq.tokens_out >= sreq.max_new_tokens:
                    req.finished = now
                    self.pending.append(self.traffic.next(req.client))
        s = time.perf_counter()
        with self._span("telemetry_flush"):
            eng._flush_telemetry()
        it.t1 = time.perf_counter()
        it.flush_s = it.t1 - s
        self.iterations.append(it)
        return it
