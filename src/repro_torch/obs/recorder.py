"""Incident flight recorder: a bounded ring of recent telemetry frames.

The recorder rides on one :class:`~repro_torch.core.telemetry.TelemetryPlane`
(the primary sidecar's, so degraded-mode replay floods never pollute
it) and keeps *references* to the last ``max_frames`` delivered
``EventBatch`` objects — batches are freshly built per tap flush and
never mutated downstream, so holding them is O(1) per frame with no
copying.  When an incident opens, :meth:`snapshot` freezes a compact
summary of the window: per-frame shape, and every ``META_*``
self-telemetry row (queue samples with ``meta >= META_KV_OCC``) so the
report shows what the plane knew about *itself* in the seconds before
the fault was detected.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from repro_torch.core.detectors import META_KV_OCC
from repro_torch.core.events import EventKind

__all__ = ["FlightRecorder"]

# Cap on frozen META rows per snapshot so reports stay small even with
# chatty self-telemetry; newest rows win.
MAX_META_ROWS = 256


class FlightRecorder:
    """Bounded ring of recent EventBatch frames + freeze-on-incident."""

    def __init__(self, max_frames: int = 64) -> None:
        self.max_frames = max_frames
        self._frames: deque[tuple[float, Any]] = deque(maxlen=max_frames)
        self.frames_seen = 0
        self.events_seen = 0

    # -- feeding (hot path: one append) ----------------------------------

    def on_batch(self, recv_ts: float, batch: Any) -> None:
        self._frames.append((recv_ts, batch))
        self.frames_seen += 1
        self.events_seen += len(batch)

    # -- introspection ----------------------------------------------------

    def occupancy(self) -> int:
        return len(self._frames)

    def window_span(self) -> float:
        """Event-time span covered by the retained ring (seconds)."""
        if not self._frames:
            return 0.0
        lo = None
        hi = None
        for _, b in self._frames:
            if len(b) == 0:
                continue
            t0 = float(b.ts[0])
            t1 = float(b.ts[-1])
            lo = t0 if lo is None or t0 < lo else lo
            hi = t1 if hi is None or t1 > hi else hi
        if lo is None or hi is None:
            return 0.0
        return hi - lo

    # -- freeze -----------------------------------------------------------

    def snapshot(self, freeze_ts: float) -> dict[str, Any]:
        """Frozen summary of the ring at incident-open time."""
        frames: list[dict[str, Any]] = []
        meta_rows: list[dict[str, Any]] = []
        qs = int(EventKind.QUEUE_SAMPLE)
        for recv_ts, b in self._frames:
            n = len(b)
            frames.append({
                "recv_ts": round(recv_ts, 6),
                "events": n,
                "ts_min": round(float(b.ts[0]), 6) if n else None,
                "ts_max": round(float(b.ts[-1]), 6) if n else None,
            })
            if n == 0:
                continue
            mask = (b.kind == qs) & (b.meta >= META_KV_OCC)
            if not mask.any():
                continue
            sel = b.compress(mask)
            for i in range(len(sel)):
                meta_rows.append({
                    "ts": round(float(sel.ts[i]), 6),
                    "meta": int(sel.meta[i]),
                    "node": int(sel.node[i]),
                    "size": int(sel.size[i]),
                    "depth": int(sel.depth[i]),
                })
        dropped = 0
        if len(meta_rows) > MAX_META_ROWS:
            dropped = len(meta_rows) - MAX_META_ROWS
            meta_rows = meta_rows[-MAX_META_ROWS:]
        return {
            "freeze_ts": round(freeze_ts, 6),
            "frames": frames,
            "frames_seen": self.frames_seen,
            "events_seen": self.events_seen,
            "window_span_s": round(self.window_span(), 6),
            "meta_rows": meta_rows,
            "meta_rows_dropped": dropped,
        }
