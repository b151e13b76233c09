"""DPU-visible event schema — the paper's observability boundary, enforced.

The paper (§4.1-4.3) is precise about what an out-of-band observer (a DPU
inline with the NIC and sitting as a PCIe peer) can and cannot see:

CAN see   : every ingress/egress packet (sub-microsecond timestamps, sizes,
            retransmit flags), every host<->device DMA transaction, doorbell
            writes (timing only), RDMA/collective bursts on the wire, NIC and
            queue depths.
CANNOT see: intra-device compute (matmuls, attention math, kernel utilization,
            HBM traffic), NVLink-only collectives, CPU-only work (§4.3).

This module encodes that boundary in the type system: there is deliberately NO
event kind that carries intra-device compute information.  Detectors consume
only these events; tests assert the enum stays closed.

On TPU the vantage points map as (see DESIGN.md §2):
  N-S  -> serving front-end request taps,
  PCIe -> host<->device transfer taps around the JAX runtime boundary,
  E-W  -> ICI collective bursts (sizes statically exact from compiled HLO,
          timing from per-host step beacons).
"""

from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np


class EventKind(enum.IntEnum):
    """Closed set of DPU-observable event kinds.

    Order groups the three vantage points of the paper's three runbooks.
    """

    # --- North-South (NIC inline; Table 3a) ---
    INGRESS_PKT = 0       # request bytes arriving from clients
    EGRESS_PKT = 1        # response/token bytes leaving toward clients
    RETRANSMIT = 2        # observed retransmission / duplicate ACK
    QUEUE_SAMPLE = 3      # periodic NIC / scheduler queue-depth sample

    # --- PCIe peer (host<->device path; Table 3b) ---
    H2D_XFER = 4          # host-to-device DMA (bytes, device, flow)
    D2H_XFER = 5          # device-to-host DMA (bytes, device, flow)
    DISPATCH = 6          # doorbell-analog: a launch happened (timing ONLY)
    MEM_REG = 7           # memory map/unmap (registration churn)

    # --- East-West (inter-node wire; Table 3c) ---
    COLLECTIVE_BURST = 8  # collective traffic burst (op kind, bytes, group)
    P2P_BURST = 9         # point-to-point transfer (PP handoff, KV migration)
    CREDIT_UPDATE = 10    # RDMA flow-control credit grant observed


#: Kinds belonging to each vantage point (used by the attribution engine).
NORTH_SOUTH = frozenset(
    {EventKind.INGRESS_PKT, EventKind.EGRESS_PKT, EventKind.RETRANSMIT,
     EventKind.QUEUE_SAMPLE}
)
PCIE = frozenset(
    {EventKind.H2D_XFER, EventKind.D2H_XFER, EventKind.DISPATCH,
     EventKind.MEM_REG}
)
EAST_WEST = frozenset(
    {EventKind.COLLECTIVE_BURST, EventKind.P2P_BURST, EventKind.CREDIT_UPDATE}
)


class CollectiveOp(enum.IntEnum):
    ALL_REDUCE = 0
    ALL_GATHER = 1
    REDUCE_SCATTER = 2
    ALL_TO_ALL = 3
    PERMUTE = 4


#: Group-id conventions for the per-collective emission tier.  The aggregate
#: TP all-reduce keeps its legacy id (group 0); the split per-op phases and
#: the rail/domain topology tier use dedicated ranges so consumers can
#: separate the tiers without any new event kinds (the enum stays closed):
#:
#:   group 0                    — aggregate TP all-reduce (legacy rows)
#:   COLL_GROUP_ALL_GATHER      — per-op all-gather rows
#:   COLL_GROUP_REDUCE_SCATTER  — per-op reduce-scatter rows
#:   RAIL_GROUP_BASE + r        — cross-domain traffic sharing rail ``r``
#:   DOMAIN_GROUP_BASE + d      — intra-domain fast-tier bursts in domain ``d``
#:
#: Per-op rows use ``depth`` as the edge marker (COLL_EDGE_*): the start row
#: carries the op's wire bytes in ``size``; the finish row is a zero-byte
#: timing edge — both are wire-visible burst boundaries, not device state.
COLL_GROUP_ALL_GATHER = 1
COLL_GROUP_REDUCE_SCATTER = 2
RAIL_GROUP_BASE = 200
DOMAIN_GROUP_BASE = 300
COLL_EDGE_START = 0
COLL_EDGE_FINISH = 1


@dataclass(frozen=True, slots=True)
class Event:
    """One observation at the DPU vantage point.

    Fields are the superset a BlueField-class observer exports; unused fields
    default to neutral values so the record stays a flat, cheap struct.
    """

    ts: float                 # seconds; sub-microsecond resolution in the sim
    kind: EventKind
    node: int                 # host/node id where observed
    device: int = -1          # local device id (PCIe events), -1 = n/a
    flow: int = -1            # request/flow/session id, -1 = n/a
    size: int = 0             # bytes on the wire / DMA transaction size
    depth: int = 0            # queue depth (QUEUE_SAMPLE) or credit count
    op: int = -1              # CollectiveOp for COLLECTIVE_BURST, -1 otherwise
    group: int = -1           # collective/TP/PP group id
    meta: int = 0             # small free int (e.g. stage id, retry count)
    replica: int = -1         # data-parallel replica the node belongs to

    def vantage(self) -> str:
        if self.kind in NORTH_SOUTH:
            return "north-south"
        if self.kind in PCIE:
            return "pcie"
        return "east-west"


# Forbidden concepts: the schema must never grow fields/kinds that expose
# intra-device compute.  Tests grep these names against the module source.
FORBIDDEN_OBSERVABLES = (
    "flops", "kernel_name", "hbm_bytes", "sm_util", "mxu_util",
    "arithmetic_intensity", "register", "warp", "occupancy",
)


#: Column order of the columnar event representation — mirrors Event's fields.
BATCH_COLUMNS = ("ts", "kind", "node", "device", "flow", "size", "depth",
                 "op", "group", "meta", "replica")


class EventBatch:
    """Structure-of-arrays view of many Events — the line-rate wire format.

    A DPU exports telemetry as ring-buffer DMA of fixed-width records, not as
    per-packet host callbacks; ``EventBatch`` is that ring in memory: one
    float64 array of timestamps plus int64 arrays for every other column,
    time-sorted.  Producers (the simulator, the serving engine, the router)
    fill an ``EventBatchBuilder`` per phase and hand the built batch to
    ``TelemetryPlane.observe_batch``; vectorized detectors consume the columns
    directly and never materialize per-event records.

    ``iter_events()`` materializes ``Event`` objects for the scalar fallback
    path and caches them, so several non-vectorized detectors sharing a batch
    pay the (expensive) materialization once.
    """

    __slots__ = BATCH_COLUMNS + ("_events", "batch_seq", "checksum")

    def __init__(self, ts: np.ndarray, kind: np.ndarray, node: np.ndarray,
                 device: np.ndarray, flow: np.ndarray, size: np.ndarray,
                 depth: np.ndarray, op: np.ndarray, group: np.ndarray,
                 meta: np.ndarray, replica: np.ndarray) -> None:
        self.ts = ts
        self.kind = kind
        self.node = node
        self.device = device
        self.flow = flow
        self.size = size
        self.depth = depth
        self.op = op
        self.group = group
        self.meta = meta
        self.replica = replica
        self._events: list[Event] | None = None
        # wire metadata, stamped by the sender (tap) side; -1/None = unset.
        # Derived batches (slice/compress) intentionally do NOT inherit
        # either field: they are new in-memory objects, not wire frames.
        self.batch_seq: int = -1
        self.checksum: int | None = None

    # -- wire integrity ---------------------------------------------------

    def content_checksum(self) -> int:
        """Cheap order-sensitive content digest for the modeled wire.

        Not cryptographic — it only needs to catch the simulated bit-rot a
        ``ModeledLink`` corruptor injects.  Computed lazily (only when a
        link's corruption knob is on), so the zero-knob hot path never pays
        for it.
        """
        acc = int(np.int64(len(self)))
        for i, col in enumerate(self.columns(), start=1):
            if col.dtype == np.float64:
                view = col.view(np.int64)
            else:
                view = col
            # wrap-around int64 sum, position-salted so column swaps and
            # row reorders change the digest
            s = int(np.bitwise_xor.reduce(
                view * np.int64(0x9E3779B1 * i))) if len(view) else 0
            acc ^= (s + i) & 0xFFFFFFFFFFFFFFFF
        return acc & 0xFFFFFFFFFFFFFFFF

    # -- construction ----------------------------------------------------

    @classmethod
    def from_events(cls, events: Sequence[Event],
                    sort: bool = True) -> "EventBatch":
        b = EventBatchBuilder()
        for ev in events:
            b.add_event(ev)
        return b.build(sort=sort)

    @classmethod
    def empty(cls) -> "EventBatch":
        z = np.empty(0, np.int64)
        return cls(np.empty(0, np.float64), z, z, z, z, z, z, z, z, z, z)

    # -- container protocol ---------------------------------------------

    def __len__(self) -> int:
        return self.ts.shape[0]

    def columns(self) -> tuple[np.ndarray, ...]:
        return tuple(getattr(self, c) for c in BATCH_COLUMNS)

    # -- derived batches (views / copies; caches are never shared) -------

    def slice(self, a: int, b: int) -> "EventBatch":
        """Contiguous sub-batch [a, b) — array views, O(1)."""
        return EventBatch(*(col[a:b] for col in self.columns()))

    def compress(self, mask: np.ndarray) -> "EventBatch":
        """Sub-batch of rows where ``mask`` is True (order preserved)."""
        idx = np.flatnonzero(mask)   # take() beats boolean-indexing 11 cols
        return EventBatch(*(col.take(idx) for col in self.columns()))

    # -- scalar interop --------------------------------------------------

    def iter_events(self) -> Iterator[Event]:
        """Materialize Events (cached) — the scalar-fallback bridge."""
        if self._events is None:
            kinds = [EventKind(k) for k in self.kind.tolist()]
            self._events = [
                Event(ts=t, kind=k, node=n, device=d, flow=f, size=s,
                      depth=q, op=o, group=g, meta=m, replica=r)
                for t, k, n, d, f, s, q, o, g, m, r in zip(
                    self.ts.tolist(), kinds, self.node.tolist(),
                    self.device.tolist(), self.flow.tolist(),
                    self.size.tolist(), self.depth.tolist(),
                    self.op.tolist(), self.group.tolist(),
                    self.meta.tolist(), self.replica.tolist())
            ]
        return iter(self._events)

    def to_events(self) -> list[Event]:
        return list(self.iter_events())


class EventBatchBuilder:
    """Columnar accumulator for one emission phase.

    Three append granularities, freely mixable (insertion order preserved):

      ``add``/``add_event`` — one row (the scalar compatibility path);
      ``add_many``          — row-staged bulk append: ``ts`` plus per-column
                              sequences/arrays or scalar broadcast;
      ``add_columns``       — the line-rate path: whole numpy column arrays
                              are appended as a chunk with no per-row Python
                              work (a simulator phase that synthesizes N
                              egress packets hands over N-row arrays once).

    ``build`` freezes everything into a time-sorted :class:`EventBatch`.
    Arrays passed to ``add_columns`` are adopted by the builder and must not
    be mutated by the caller afterwards.
    """

    __slots__ = ("_cols", "_chunk_cols", "_chunk_sizes")

    def __init__(self) -> None:
        # row staging (scalar adds) + sealed column chunks, in insertion
        # order: staged rows are sealed into a chunk whenever a column
        # chunk arrives, so build() sees one ordered chunk list
        self._cols: list[list] = [[] for _ in BATCH_COLUMNS]
        self._chunk_cols: list[list] = [[] for _ in BATCH_COLUMNS]
        self._chunk_sizes: list[int] = []

    def __len__(self) -> int:
        return sum(self._chunk_sizes) + len(self._cols[0])

    def clear(self) -> None:
        for c in self._cols:
            c.clear()
        for c in self._chunk_cols:
            c.clear()
        self._chunk_sizes.clear()

    def add(self, ts: float, kind: int, node: int, device: int = -1,
            flow: int = -1, size: int = 0, depth: int = 0, op: int = -1,
            group: int = -1, meta: int = 0, replica: int = -1) -> None:
        c = self._cols
        c[0].append(ts)
        c[1].append(int(kind))
        c[2].append(node)
        c[3].append(device)
        c[4].append(flow)
        c[5].append(size)
        c[6].append(depth)
        c[7].append(op)
        c[8].append(group)
        c[9].append(meta)
        c[10].append(replica)

    def add_event(self, ev: Event) -> None:
        self.add(ev.ts, int(ev.kind), ev.node, ev.device, ev.flow, ev.size,
                 ev.depth, ev.op, ev.group, ev.meta, ev.replica)

    def add_many(self, ts: Sequence[float], kind: int, node=0, device=-1,
                 flow=-1, size=0, depth=0, op=-1, group=-1, meta=0,
                 replica=-1) -> None:
        """Bulk append: ``ts`` is a sequence (list/tuple/ndarray); every
        other column is a same-length sequence/array or a scalar broadcast
        across the rows.  Lengths are validated; mismatches raise."""
        n = len(ts)
        if n == 0:
            return
        vals = (kind, node, device, flow, size, depth, op, group, meta,
                replica)
        # validate every column length BEFORE extending any row staging,
        # so a raised error cannot leave ragged partial rows behind
        for i, v in enumerate(vals, start=1):
            if isinstance(v, np.ndarray):
                if v.shape != (n,):
                    raise ValueError(
                        f"add_many: column {BATCH_COLUMNS[i]} has shape "
                        f"{v.shape}, expected ({n},)")
            elif isinstance(v, (list, tuple)) and len(v) != n:
                raise ValueError(
                    f"add_many: column {BATCH_COLUMNS[i]} has length "
                    f"{len(v)}, expected {n}")
        c = self._cols
        c[0].extend(ts.tolist() if isinstance(ts, np.ndarray) else ts)
        for i, v in enumerate(vals, start=1):
            if isinstance(v, np.ndarray):
                c[i].extend(v.tolist())
            elif isinstance(v, (list, tuple)):
                c[i].extend(v)
            else:
                c[i].extend(itertools.repeat(int(v), n))

    def add_columns(self, ts, kind, node=0, device=-1, flow=-1, size=0,
                    depth=0, op=-1, group=-1, meta=0, replica=-1) -> None:
        """Append whole column arrays as one chunk — zero per-row work.

        ``ts`` is a 1-D float array (or sequence); every other column is a
        same-length integer array or a scalar, broadcast lazily at
        ``build`` time (scalars are stored as-is, so an N-row chunk with
        ten scalar columns costs one array, not eleven).  Dtypes are
        validated: integer columns reject float arrays rather than
        silently truncating.
        """
        if type(ts) is not np.ndarray or ts.dtype != np.float64:
            ts = np.asarray(ts, np.float64)
        if ts.ndim != 1:
            raise ValueError(f"add_columns: ts must be 1-D, got {ts.shape}")
        n = ts.shape[0]
        if n == 0:
            return
        # validate/cook every column BEFORE touching builder state, so a
        # raised error cannot leave orphaned column fragments behind
        cooked = [ts]
        i = 1
        for v in (kind, node, device, flow, size, depth, op, group, meta,
                  replica):
            if isinstance(v, np.ndarray):
                if v.shape != (n,):
                    raise ValueError(
                        f"add_columns: column {BATCH_COLUMNS[i]} has shape "
                        f"{v.shape}, expected ({n},)")
                if v.dtype != np.int64:
                    if not np.issubdtype(v.dtype, np.integer):
                        raise TypeError(
                            f"add_columns: column {BATCH_COLUMNS[i]} has "
                            f"dtype {v.dtype}; integer required")
                    v = v.astype(np.int64)
                cooked.append(v)
            else:
                cooked.append(int(v))
            i += 1
        if self._cols[0]:
            self._seal_rows()
        chunk_cols = self._chunk_cols
        for i, v in enumerate(cooked):
            chunk_cols[i].append(v)
        self._chunk_sizes.append(n)

    def _seal_rows(self) -> None:
        if not self._cols[0]:
            return
        self._chunk_sizes.append(len(self._cols[0]))
        self._chunk_cols[0].append(np.asarray(self._cols[0], np.float64))
        for i in range(1, len(BATCH_COLUMNS)):
            self._chunk_cols[i].append(np.asarray(self._cols[i], np.int64))
        for c in self._cols:
            c.clear()

    def build(self, sort: bool = True) -> EventBatch:
        self._seal_rows()
        sizes = self._chunk_sizes
        if not sizes:
            return EventBatch.empty()
        if len(sizes) == 1:
            n = sizes[0]
            cols = [self._chunk_cols[0][0]]
            for col in self._chunk_cols[1:]:
                v = col[0]
                cols.append(v if isinstance(v, np.ndarray)
                            else np.full(n, v, np.int64))
        else:
            # preallocate + slice-fill: scalar chunks become C-level fills
            # instead of materialized broadcast arrays
            total = sum(sizes)
            cols = [np.concatenate(self._chunk_cols[0])]
            for col in self._chunk_cols[1:]:
                out = np.empty(total, np.int64)
                pos = 0
                for v, n in zip(col, sizes):
                    out[pos:pos + n] = v
                    pos += n
                cols.append(out)
        ts = cols[0]
        if sort and ts.shape[0] > 1 and np.any(ts[1:] < ts[:-1]):
            order = np.argsort(ts, kind="stable")
            cols = [col[order] for col in cols]
        return EventBatch(*cols)


class EventTraceRecorder:
    """Minimal observe_batch-protocol sink: records every emitted batch.

    Duck-type-compatible with the slot a ``TelemetryPlane`` occupies on a
    producer (``observe_batch`` + a falsy ``findings``), so benchmarks, the
    batch/scalar equivalence tests, and offline trace capture can tap the
    columnar wire format without running any detectors.
    """

    findings: tuple = ()

    def __init__(self) -> None:
        self.batches: list[EventBatch] = []

    def observe_batch(self, batch: "EventBatch") -> None:
        self.batches.append(batch)


class EventStream:
    """Bounded ring buffer of recent telemetry with batch fan-out.

    The simulator and the live engine both write here (per-event ``emit`` or
    columnar ``emit_batch``); detectors read.  Retention is bounded: the
    stream keeps at most ``capacity`` recent events (evicting whole chunks,
    oldest first) so a long sweep's memory stays flat — line-rate constraints
    on *state* are modeled by the sketches (O(1) memory); this container is
    the replay/debug window a DPU would hold in its ring.  Tests that need
    the complete trace pass ``full_trace=True``.

    Subscribers receive :class:`EventBatch` chunks (batch fan-out); a scalar
    ``emit`` wraps the event into a one-row batch only when subscribers
    exist, so the hot path pays nothing for an unused hook.
    """

    __slots__ = ("capacity", "full_trace", "_chunks", "_retained",
                 "_tail", "_total", "_subscribers")

    DEFAULT_CAPACITY = 1 << 16

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 full_trace: bool = False) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.full_trace = full_trace
        # chunks are either list[Event] (scalar emits) or EventBatch
        self._chunks: deque = deque()
        self._tail: list[Event] = []
        self._retained = 0      # events currently held
        self._total = 0         # events ever emitted
        self._subscribers: list[Callable[["EventBatch"], None]] = []

    # -- ingestion -------------------------------------------------------

    def emit(self, event: Event) -> None:
        self._tail.append(event)
        self._retained += 1
        self._total += 1
        if self._subscribers:
            batch = EventBatch.from_events([event], sort=False)
            for sub in self._subscribers:
                sub(batch)
        if len(self._tail) >= 1024:
            self._seal_tail()

    def emit_batch(self, batch: "EventBatch") -> None:
        n = len(batch)
        if n == 0:
            return
        self._seal_tail()
        self._chunks.append(batch)
        self._retained += n
        self._total += n
        for sub in self._subscribers:
            sub(batch)
        self._trim()

    def extend(self, events: Iterable[Event]) -> None:
        for e in events:
            self.emit(e)

    def subscribe(self, fn: Callable[["EventBatch"], None]) -> None:
        """Register a batch consumer: called with every emitted EventBatch
        (scalar emits arrive as one-row batches)."""
        self._subscribers.append(fn)

    def _seal_tail(self) -> None:
        if self._tail:
            self._chunks.append(self._tail)
            self._tail = []
            self._trim()

    def _trim(self) -> None:
        if self.full_trace:
            return
        # evict oldest whole chunks; retention is approximate at chunk
        # granularity, which keeps eviction O(1) amortized
        while self._retained > self.capacity and len(self._chunks) > 1:
            old = self._chunks.popleft()
            self._retained -= len(old)

    # -- reading ---------------------------------------------------------

    def __len__(self) -> int:
        return self._retained

    @property
    def total_events(self) -> int:
        """Events ever emitted (retention-independent counter)."""
        return self._total

    def __iter__(self) -> Iterator[Event]:
        for chunk in list(self._chunks):
            if isinstance(chunk, EventBatch):
                yield from chunk.iter_events()
            else:
                yield from chunk
        yield from list(self._tail)

    def select(
        self,
        kind: EventKind | None = None,
        node: int | None = None,
        device: int | None = None,
        flow: int | None = None,
        t0: float = float("-inf"),
        t1: float = float("inf"),
    ) -> list[Event]:
        out = []
        for e in self:
            if kind is not None and e.kind != kind:
                continue
            if node is not None and e.node != node:
                continue
            if device is not None and e.device != device:
                continue
            if flow is not None and e.flow != flow:
                continue
            if not (t0 <= e.ts <= t1):
                continue
            out.append(e)
        return out

    def merged(*streams: "EventStream") -> list[Event]:
        """Time-ordered merge of several per-node streams (cluster view)."""
        return sorted(
            itertools.chain.from_iterable(streams),
            key=lambda e: e.ts,
        )
