"""Continuous-batching scheduler with the paper's Table 2(b) signal surface.

Implements the software-side sensing the paper catalogs: request arrival
times, sequence lengths (length bucketing), decode progress, queue depth /
wait time, KV-cache occupancy — and exposes the knobs the mitigation
controller actuates (admission control, batching window, bucketing).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class ServeRequest:
    req_id: int
    arrival: float
    prompt: list[int]
    max_new_tokens: int
    # lifecycle timestamps (Table 2b software record-keeping)
    admitted: float = -1.0
    first_token: float = -1.0
    finished: float = -1.0
    tokens_out: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival if self.first_token >= 0 \
            else float("inf")

    @property
    def latency(self) -> float:
        return self.finished - self.arrival if self.finished >= 0 \
            else float("inf")


@dataclass
class SchedulerConfig:
    max_slots: int = 8
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024)
    batch_window: float = 0.0       # admission smoothing window (seconds)
    admission_paused: bool = False
    continuous: bool = True          # False = static batching (pathological)


class Scheduler:
    """Queue + slot assignment + length bucketing + admission control."""

    def __init__(self, cfg: SchedulerConfig) -> None:
        self.cfg = cfg
        self.queue: list[ServeRequest] = []
        self.running: dict[int, ServeRequest] = {}   # slot -> request
        self.free_slots: list[int] = list(range(cfg.max_slots))
        self.wait_times: list[float] = []
        self._admit_after = 0.0

    # -- signals (Table 2b) -------------------------------------------

    def queue_depth(self) -> int:
        return len(self.queue)

    def decode_progress(self) -> dict[int, int]:
        return {slot: r.tokens_out for slot, r in self.running.items()}

    # -- knobs (mitigation actuation) ----------------------------------

    def pause_admission(self, until: float) -> None:
        self._admit_after = max(self._admit_after, until)

    def set_batch_window(self, window: float) -> None:
        self.cfg.batch_window = window

    def set_continuous(self, on: bool) -> None:
        self.cfg.continuous = on

    # -- scheduling -----------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)

    def bucket_len(self, n: int) -> int:
        bs = self.cfg.prefill_buckets
        i = bisect.bisect_left(bs, n)
        return bs[min(i, len(bs) - 1)]

    def admissible(self, now: float) -> bool:
        if self.cfg.admission_paused or now < self._admit_after:
            return False
        if not self.cfg.continuous and self.running:
            # static batching: a batch may only be FORMED while empty or
            # within the same scheduling tick; once decoding, full drain
            if any(r.admitted < now for r in self.running.values()):
                return False
        return bool(self.queue) and bool(self.free_slots)

    def admit(self, now: float) -> tuple[int, ServeRequest] | None:
        """Assign the longest-waiting request to a slot."""
        if not self.admissible(now):
            return None
        req = self.queue.pop(0)
        slot = self.free_slots.pop(0)
        req.admitted = now
        self.wait_times.append(now - req.arrival)
        self.running[slot] = req
        if self.cfg.batch_window > 0:
            self._admit_after = now + self.cfg.batch_window
        return slot, req

    def release(self, slot: int, now: float) -> ServeRequest:
        req = self.running.pop(slot)
        req.finished = now
        self.free_slots.append(slot)
        self.free_slots.sort()
        return req
