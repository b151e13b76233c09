"""Hierarchical cross-replica request router — the data-parallel dispatch
layer, at replica -> node -> device granularity.

The paper's decode-phase load imbalance is hierarchical: skew appears
across DP replicas, across nodes inside a replica, and across devices
inside a node.  A front-end router that only sees the replica tier fixes
the first and is blind to the other two; a router fed a *stale* view — or
one whose session affinity defeats its balancing — manufactures exactly
the pathologies Table 3(d) catalogs.

Pieces:

  NodeSnapshot     — router-visible state of one cluster node inside a
                     replica (queue depth, active slots, KV occupancy,
                     per-device live-sequence counts).
  ReplicaSnapshot  — the replica-tier aggregate at time ts, carrying its
                     ``nodes`` tree.  Deliberately the same information a
                     DPU-side collector exports: queue samples and
                     KV-occupancy telemetry, no model internals.
  HierarchicalView — per-replica snapshot history with an explicit
                     staleness model and node/device-tier access.
                     Snapshots are inserted in timestamp order (the view
                     transport jitters, so arrivals may be out of order).
  RouterPolicy     — pluggable two-stage decision rule: ``choose`` picks a
                     replica; hierarchical policies also implement
                     ``choose_node`` to pick a node slot within it.
                       round_robin          (static, load-blind)
                       join_shortest_queue  (queued + active work units)
                       least_kv             (lowest KV-cache occupancy)
                       prediction_aware     (lowest expected remaining
                                             decode tokens)
                       prefix_affinity      (consistent-hash on the request
                                             session/prefix key, load-
                                             ceiling spill to JSQ)
                       hierarchical_jsq     (replica whose least-loaded
                                             node is least loaded, then
                                             that node; device counts
                                             break ties)
  Router           — routes RequestInfo -> replica (and node, for
                     hierarchical policies), with optimistic local
                     accounting between view refreshes.  Staleness is a
                     *measured* property of the view transport
                     (``view_lag``); optimistic bumps switch off by
                     themselves once the view lags beyond
                     ``bump_lag_tol`` — the stale-router-view pathology no
                     longer needs a knob (the legacy ``staleness`` knob is
                     retained for explicit experiments).
  ReplicaSet       — N live engines behind one Router.  The view refresh
                     is periodic (``refresh_period``) and telemetry-borne:
                     snapshots travel through a ``ModeledLink``
                     (``repro_torch.dpu.transport``), so the router's view lags,
                     jitters, and drops exactly like the DPU's uplink
                     does.  The same message carries the columnar
                     QUEUE_SAMPLE rows the detection plane consumes.

Every routing decision is recorded; tests assert conservation (no request
dropped, each routed exactly once) and the JSQ invariant (never route to a
strictly longer queue than the minimum in view).
"""

from __future__ import annotations

import dataclasses
import random
from bisect import bisect_right, insort
from dataclasses import dataclass, field
from zlib import crc32

import numpy as np

from repro_torch.core.events import EventBatchBuilder, EventKind
from repro_torch.dpu.transport import LinkParams, ModeledLink


@dataclass(frozen=True)
class NodeSnapshot:
    """Router-visible state of one cluster node within a replica."""

    node: int                   # cluster node id
    queue_depth: int = 0        # requests queued on this node
    active: int = 0             # requests currently decoding on this node
    slots: int = 1              # decode slot capacity
    kv_occupancy: float = 0.0   # 0..1 fraction of this node's KV pool
    expected_work: float = 0.0  # predicted remaining decode tokens
    dev_active: tuple[int, ...] = ()   # live sequences per device slot

    @property
    def backlog(self) -> int:
        return self.queue_depth + self.active


@dataclass(frozen=True)
class ReplicaSnapshot:
    """Router-visible state of one replica at a point in time."""

    replica: int
    ts: float
    queue_depth: int = 0        # requests waiting, not yet in a decode slot
    active: int = 0             # requests currently decoding
    slots: int = 1              # decode slot capacity (for normalization)
    kv_occupancy: float = 0.0   # 0..1 fraction of KV pool in use
    expected_work: float = 0.0  # predicted remaining decode tokens (queued+active)
    nodes: tuple[NodeSnapshot, ...] = ()   # per-node tier (may be empty)

    @property
    def backlog(self) -> int:
        """Total requests the replica is responsible for right now."""
        return self.queue_depth + self.active


@dataclass(frozen=True)
class RequestInfo:
    """What the router may know about a request at dispatch time."""

    flow: int
    prompt_len: int = 0
    predicted_decode: float = 0.0   # expected decode length (workload model)
    session: int = -1               # prefix/session affinity key (-1: none)

    @property
    def affinity_key(self) -> int:
        """The key prefix-affinity policies hash: the session when the
        front-end knows it, else the flow id."""
        return self.session if self.session >= 0 else self.flow


@dataclass(frozen=True)
class RoutingDecision:
    ts: float
    flow: int
    replica: int
    policy: str
    view_ts: float              # timestamp of the snapshot the choice used
    node: int = -1              # node slot (hierarchical policies only)


class RouterView:
    """Per-replica snapshot history with an explicit staleness model.

    ``get(replica, now, staleness)`` returns the newest snapshot no younger
    than ``now - staleness`` — i.e. what an eventually-consistent router
    actually knows.  History is kept **sorted by snapshot timestamp**:
    the view transport jitters, so snapshots can arrive out of order, and
    an append-only history would corrupt both the age-pruning cutoff and
    the newest-first scan in ``get``.  Pruning is by AGE relative to the
    newest snapshot *held* (``max_age``, which callers must keep >= the
    deepest staleness they will ask for), with a generous entry-count
    backstop so a pathological snapshot flood stays bounded.
    """

    MAX_HISTORY = 4096      # backstop only; age-based pruning is primary

    def __init__(self, n_replicas: int, max_age: float = 2.0) -> None:
        self.n_replicas = n_replicas
        self.max_age = max_age
        self._hist: list[list[ReplicaSnapshot]] = [
            [] for _ in range(n_replicas)]

    def update(self, snap: ReplicaSnapshot) -> None:
        h = self._hist[snap.replica]
        # insert in ts order (equal timestamps keep arrival order); a late
        # out-of-order snapshot lands in sorted position instead of
        # masquerading as the newest state
        if h and snap.ts < h[-1].ts:
            insort(h, snap, key=lambda s: s.ts)
        else:
            h.append(snap)
        # prune by age of the newest snapshot HELD (h[-1] after insertion,
        # never the just-arrived one — a stale arrival must not drag the
        # cutoff backward)
        cutoff = h[-1].ts - self.max_age
        drop = 0
        while drop < len(h) - 1 and h[drop + 1].ts <= cutoff:
            drop += 1
        if len(h) - drop > self.MAX_HISTORY:
            drop = len(h) - self.MAX_HISTORY
        if drop:
            del h[:drop]

    def get(self, replica: int, now: float,
            staleness: float = 0.0) -> ReplicaSnapshot:
        h = self._hist[replica]
        if not h:
            return ReplicaSnapshot(replica=replica, ts=float("-inf"))
        if staleness <= 0.0:
            return h[-1]
        cutoff = now - staleness
        for snap in reversed(h):
            if snap.ts <= cutoff:
                return snap
        return h[0]     # nothing old enough: the oldest we have

    def latest_ts(self, replica: int) -> float:
        h = self._hist[replica]
        return h[-1].ts if h else float("-inf")


class HierarchicalView(RouterView):
    """RouterView plus node/device-tier access over the snapshot tree."""

    def nodes(self, replica: int, now: float,
              staleness: float = 0.0) -> tuple[NodeSnapshot, ...]:
        """Node snapshots of one replica as of ``now - staleness``."""
        return self.get(replica, now, staleness).nodes

    def tree(self, now: float,
             staleness: float = 0.0) -> dict[int, dict[int, NodeSnapshot]]:
        """The full replica -> node -> snapshot tree the policies see."""
        out: dict[int, dict[int, NodeSnapshot]] = {}
        for r in range(self.n_replicas):
            out[r] = {ns.node: ns for ns in self.nodes(r, now, staleness)}
        return out


class RouterPolicy:
    """Two-stage decision rule over the (possibly stale) view.

    ``choose`` picks a replica.  Policies that understand the node tier set
    ``hierarchical = True`` and implement ``choose_node``; for the rest the
    caller falls back to its own spread (the sim round-robins over the
    replica's TP group, exactly the flat-router behavior).
    """

    name: str = "abstract"
    hierarchical: bool = False

    def choose(self, snaps: list[ReplicaSnapshot], req: RequestInfo,
               rng: random.Random) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def choose_node(self, snap: ReplicaSnapshot, req: RequestInfo,
                    rng: random.Random) -> int:
        """Pick a node slot within the chosen replica; -1 defers to the
        caller's flat spread."""
        return -1

    @staticmethod
    def _argmin(snaps: list[ReplicaSnapshot], key,
                rng: random.Random) -> int:
        best = min(key(s) for s in snaps)
        ties = [s.replica for s in snaps if key(s) == best]
        return ties[0] if len(ties) == 1 else rng.choice(ties)

    @staticmethod
    def _argmin_node(nodes: tuple[NodeSnapshot, ...], key,
                     rng: random.Random) -> int:
        best = min(key(ns) for ns in nodes)
        ties = [ns.node for ns in nodes if key(ns) == best]
        return ties[0] if len(ties) == 1 else rng.choice(ties)


class RoundRobinPolicy(RouterPolicy):
    """Static rotation — load-blind; the baseline every DP router starts as."""

    name = "round_robin"

    def __init__(self) -> None:
        self._i = -1

    def choose(self, snaps, req, rng):
        self._i = (self._i + 1) % len(snaps)
        return snaps[self._i].replica


class JoinShortestQueuePolicy(RouterPolicy):
    """Route to the replica with the fewest queued + active requests."""

    name = "join_shortest_queue"

    def choose(self, snaps, req, rng):
        return self._argmin(snaps, lambda s: s.backlog, rng)


class LeastKVPolicy(RouterPolicy):
    """Route to the replica with the lowest KV-cache occupancy.

    KV occupancy integrates sequence *length*, not just request count, so it
    sees heavy hitters that JSQ's unit counting misses — but it reacts more
    slowly, because occupancy only moves once a request is admitted.
    Queue depth breaks ties so an un-admitted backlog still repels traffic.
    """

    name = "least_kv"

    def choose(self, snaps, req, rng):
        return self._argmin(
            snaps, lambda s: (round(s.kv_occupancy, 3), s.backlog), rng)


class PredictionAwarePolicy(RouterPolicy):
    """Route to the replica with the least expected remaining decode work.

    ``expected_work`` sums the workload model's expected decode length over
    the replica's queued + active requests minus tokens already produced —
    the universal-load-balancing-principle estimate of time-to-drain.
    """

    name = "prediction_aware"

    def choose(self, snaps, req, rng):
        return self._argmin(snaps, lambda s: s.expected_work, rng)


class PrefixAffinityPolicy(RouterPolicy):
    """Consistent-hash session affinity with a load-ceiling spill to JSQ.

    Requests sharing a prefix/session key land on the same *home* replica
    (and the same home node within it), so the home's prefix cache keeps
    serving the shared prompt prefix — the affinity half of the
    affinity-vs-balance tension online DP routers live in.  The balance
    half is the spill rule: when the home's backlog exceeds
    ``spill_factor`` x the mean (with an absolute ``spill_floor`` so a
    near-idle cluster never spills), the request joins the shortest queue
    instead — a hot session degrades into routable load rather than a hot
    replica.  The hash ring is seeded and static, so placement is
    deterministic and survives view churn.
    """

    name = "prefix_affinity"
    hierarchical = True
    VNODES = 64                 # virtual points per replica on the ring

    def __init__(self, spill_factor: float = 1.25,
                 spill_floor: int = 4) -> None:
        self.spill_factor = spill_factor
        self.spill_floor = spill_floor
        self._ring_n = -1
        self._ring_keys: list[int] = []
        self._ring_owner: list[int] = []
        self.spills = 0

    def _build_ring(self, n: int) -> None:
        pts = sorted(
            (crc32(f"replica:{r}:{v}".encode()), r)
            for r in range(n) for v in range(self.VNODES))
        self._ring_keys = [p[0] for p in pts]
        self._ring_owner = [p[1] for p in pts]
        self._ring_n = n

    def home_replica(self, key: int, n: int) -> int:
        """Consistent-hash home for an affinity key among n replicas."""
        if self._ring_n != n:
            self._build_ring(n)
        h = crc32(str(key).encode())
        i = bisect_right(self._ring_keys, h) % len(self._ring_keys)
        return self._ring_owner[i]

    def _ceiling(self, backlogs: list[int]) -> float:
        mean = sum(backlogs) / len(backlogs)
        return max(self.spill_floor, self.spill_factor * mean)

    def choose(self, snaps, req, rng):
        home = self.home_replica(req.affinity_key, len(snaps))
        if snaps[home].backlog <= self._ceiling(
                [s.backlog for s in snaps]):
            return home
        self.spills += 1
        return self._argmin(snaps, lambda s: s.backlog, rng)

    def choose_node(self, snap, req, rng):
        nodes = snap.nodes
        if not nodes:
            return -1
        if len(nodes) == 1:
            return nodes[0].node
        home = nodes[crc32(b"node:%d" % req.affinity_key) % len(nodes)]
        if home.backlog <= self._ceiling([ns.backlog for ns in nodes]):
            return home.node
        return self._argmin_node(nodes, lambda ns: ns.backlog, rng)


class HierarchicalJSQPolicy(RouterPolicy):
    """Two-stage JSQ over the snapshot tree.

    Stage 1 picks the replica whose *least-loaded node* has the most free
    room (replica backlog breaks ties) — which differs from flat JSQ
    exactly when replica totals are balanced but intra-replica node skew
    hides a free node.  Stage 2 joins that node; per-device live-sequence
    counts break node ties so the freest device slot wins.
    """

    name = "hierarchical_jsq"
    hierarchical = True

    @staticmethod
    def _node_key(ns: NodeSnapshot) -> tuple:
        return (ns.backlog, min(ns.dev_active) if ns.dev_active else 0)

    def choose(self, snaps, req, rng):
        def key(s: ReplicaSnapshot):
            if s.nodes:
                return (min(ns.backlog for ns in s.nodes), s.backlog)
            return (s.backlog, s.backlog)
        return self._argmin(snaps, key, rng)

    def choose_node(self, snap, req, rng):
        if not snap.nodes:
            return -1
        return self._argmin_node(snap.nodes, self._node_key, rng)


POLICIES: dict[str, type[RouterPolicy]] = {
    p.name: p for p in (RoundRobinPolicy, JoinShortestQueuePolicy,
                        LeastKVPolicy, PredictionAwarePolicy,
                        PrefixAffinityPolicy, HierarchicalJSQPolicy)
}


def make_policy(policy: str | RouterPolicy) -> RouterPolicy:
    if isinstance(policy, RouterPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown router policy {policy!r}; have {sorted(POLICIES)}")


class Router:
    """Dispatches requests across N replicas under a pluggable policy.

    Between view refreshes the router does optimistic local accounting:
    each dispatch bumps the cached snapshot's backlog/expected_work (and
    the chosen node's, for hierarchical policies) so that a burst arriving
    inside one refresh interval still spreads out.  The bumps assume the
    view is *fresh*; once the newest snapshot for a replica is older than
    ``bump_lag_tol`` — the view transport is lagging — the router can no
    longer trust that a refresh reflects its recent dispatches, so the
    bumps switch off and the stale-router-view pathology emerges from the
    link itself.  The legacy ``staleness`` knob (> 0 widens reads to
    ``now - staleness`` and disables bumps outright) is retained for
    explicit experiments.
    """

    #: view age beyond which optimistic bumps are distrusted (s); must
    #: exceed any healthy refresh period + transport delay
    BUMP_LAG_TOL = 0.05

    def __init__(self, n_replicas: int,
                 policy: str | RouterPolicy = "round_robin",
                 staleness: float = 0.0, seed: int = 0,
                 bump_lag_tol: float | None = None) -> None:
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.n_replicas = n_replicas
        self.policy = make_policy(policy)
        self.rng = random.Random(seed ^ 0x7077E7)
        self.view = HierarchicalView(n_replicas)
        self.bump_lag_tol = (self.BUMP_LAG_TOL if bump_lag_tol is None
                             else bump_lag_tol)
        self.staleness = staleness      # property: widens view retention
        self.decisions: list[RoutingDecision] = []
        self.routed_per_replica: list[int] = [0] * n_replicas
        # optimistic deltas since each replica's last snapshot
        self._bump_backlog: list[int] = [0] * n_replicas
        self._bump_work: list[float] = [0.0] * n_replicas
        self._bump_node: dict[int, int] = {}    # node id -> dispatches

    @property
    def staleness(self) -> float:
        return self._staleness

    @staleness.setter
    def staleness(self, value: float) -> None:
        # the view must retain history at least as deep as the staleness we
        # will read at, or get() would silently serve fresher state
        self._staleness = value
        if value > 0:
            self.view.max_age = max(self.view.max_age, 2.0 * value)

    # -- view ingestion --------------------------------------------------

    def observe(self, snap: ReplicaSnapshot) -> None:
        """Ingest one snapshot (however late the transport delivered it —
        the measured view lag is always ``now - latest_ts`` at read time,
        so delivery time needs no separate bookkeeping here).

        Optimistic bumps are deltas since the snapshot the view *serves*;
        a late out-of-order arrival (older than the newest held) does not
        replace that snapshot, so it must not clear the deltas either —
        resetting on it would make the replica look emptier than its
        retained state and dogpile the next burst."""
        newest = snap.ts >= self.view.latest_ts(snap.replica)
        self.view.update(snap)
        if newest:
            self._bump_backlog[snap.replica] = 0
            self._bump_work[snap.replica] = 0.0
            for ns in snap.nodes:
                self._bump_node.pop(ns.node, None)

    def view_lag(self, now: float) -> float:
        """Measured staleness of the view (s): age of the newest snapshot,
        worst case across replicas.  This is a property of the transport
        feeding the router, not a knob — inf until every replica has
        reported at least once."""
        return max(now - self.view.latest_ts(r)
                   for r in range(self.n_replicas))

    # -- routing ---------------------------------------------------------

    def _bumps_fresh(self, snap: ReplicaSnapshot, now: float) -> bool:
        """Optimistic accounting applies only to a fresh view: the legacy
        staleness knob disables it, and so does a measured view lag beyond
        tolerance.  An empty view (ts == -inf) counts as fresh — the
        router has dispatched nothing the view could be missing."""
        if self._staleness > 0.0:
            return False
        return snap.ts == float("-inf") or now - snap.ts <= self.bump_lag_tol

    def _effective(self, replica: int, now: float) -> ReplicaSnapshot:
        snap = self.view.get(replica, now, self.staleness)
        if not self._bumps_fresh(snap, now):
            return snap
        b, w = self._bump_backlog[replica], self._bump_work[replica]
        if b == 0 and w == 0.0:
            return snap
        return dataclasses.replace(
            snap, queue_depth=snap.queue_depth + b,
            expected_work=snap.expected_work + w)

    def _node_effective(self, snap: ReplicaSnapshot) -> ReplicaSnapshot:
        """Fold node-level optimistic bumps into the node tier."""
        nb = self._bump_node
        if not nb or not snap.nodes:
            return snap
        nodes = tuple(
            dataclasses.replace(ns, queue_depth=ns.queue_depth + nb[ns.node])
            if ns.node in nb else ns
            for ns in snap.nodes)
        return dataclasses.replace(snap, nodes=nodes)

    def route_ex(self, req: RequestInfo, now: float = 0.0) -> RoutingDecision:
        """Two-stage routing: policy picks a replica, then (for
        hierarchical policies) a node slot within it.  ``decision.node``
        is -1 when the policy left node placement to the caller."""
        snaps = [self._effective(r, now) for r in range(self.n_replicas)]
        if self.policy.hierarchical:
            # node-tier optimistic bumps must be visible to BOTH stages:
            # stage 1 ranks replicas by their node interiors
            snaps = [self._node_effective(s) if self._bumps_fresh(s, now)
                     else s for s in snaps]
        replica = self.policy.choose(snaps, req, self.rng)
        if not 0 <= replica < self.n_replicas:
            raise RuntimeError(
                f"policy {self.policy.name} chose invalid replica {replica}")
        node = -1
        if self.policy.hierarchical and snaps[replica].nodes:
            node = self.policy.choose_node(snaps[replica], req, self.rng)
            if node >= 0:
                self._bump_node[node] = self._bump_node.get(node, 0) + 1
        self.routed_per_replica[replica] += 1
        self._bump_backlog[replica] += 1
        self._bump_work[replica] += max(req.predicted_decode, 1.0)
        decision = RoutingDecision(
            ts=now, flow=req.flow, replica=replica,
            policy=self.policy.name,
            view_ts=snaps[replica].ts, node=node)
        self.decisions.append(decision)
        return decision

    def route(self, req: RequestInfo, now: float = 0.0) -> int:
        return self.route_ex(req, now).replica

    # -- introspection ---------------------------------------------------

    def imbalance(self) -> float:
        """max/mean routed-count ratio (1.0 = perfectly even)."""
        total = sum(self.routed_per_replica)
        if total == 0:
            return 1.0
        mean = total / self.n_replicas
        return max(self.routed_per_replica) / mean


# ----------------------------------------------------------------------
# live-engine replica set
# ----------------------------------------------------------------------

def engine_snapshot(engine, replica: int, now: float,
                    default_decode: float = 32.0,
                    node_base: int | None = None) -> ReplicaSnapshot:
    """Build a ReplicaSnapshot from an InferenceEngine-shaped object.

    Duck-typed: needs ``sched`` (queue, running, cfg.max_slots) and ``pool``
    (occupancy()).  Works on the real engine and on test stubs alike.  The
    snapshot carries a one-node tier (an engine is one serving node;
    ``node_base`` places it in the cluster's node coordinate space) with
    per-device live counts derived from the engine's slot ids — the same
    device axis its DISPATCH/D2H telemetry uses.
    """
    sched = engine.sched
    queued = list(sched.queue)
    running = list(sched.running.values())
    work = 0.0
    for r in queued:
        work += max(getattr(r, "max_new_tokens", default_decode), 1.0)
    for r in running:
        rem = (getattr(r, "max_new_tokens", default_decode)
               - getattr(r, "tokens_out", 0))
        work += max(rem, 1.0)
    occ = float(engine.pool.occupancy())
    slot_ids = [k for k in getattr(sched, "running", {})
                if isinstance(k, int)]
    if slot_ids:
        dev = [0, 0, 0, 0]
        for k in slot_ids:          # engine telemetry maps slot -> slot % 4
            dev[k % 4] += 1
        dev_active = tuple(dev)
    else:
        dev_active = ()
    node_id = replica if node_base is None else node_base
    node = NodeSnapshot(
        node=node_id, queue_depth=len(queued), active=len(running),
        slots=sched.cfg.max_slots, kv_occupancy=occ, expected_work=work,
        dev_active=dev_active)
    return ReplicaSnapshot(
        replica=replica, ts=now,
        queue_depth=len(queued), active=len(running),
        slots=sched.cfg.max_slots,
        kv_occupancy=occ,
        expected_work=work, nodes=(node,))


class ReplicaSet:
    """N serving-engine replicas behind one Router.

    The router's view is **telemetry-borne**: ``refresh`` snapshots every
    engine on a configurable period (not per request — re-snapshotting
    every engine on every submit is O(n_replicas) per request and defeats
    the staleness model entirely) and publishes the snapshots through a
    :class:`ModeledLink`, the same transport abstraction the DPU uplink
    uses.  The router only learns a snapshot when the link delivers it, so
    ``Router.view_lag`` is a measured property of the link (delay, jitter,
    loss) rather than a configuration knob.  The default link is
    zero-latency/lossless (a front-end colocated with its replicas);
    experiments pass real ``LinkParams``.

    When a ``plane`` is attached, the front-end renders its own activity as
    DPU-visible telemetry through the same columnar path the simulator and
    engines use: one INGRESS_PKT per routed request (tagged with the chosen
    replica) and one ingress QUEUE_SAMPLE per replica per *delivered* view
    refresh — the queue columns ride the same modeled link as the router's
    view, so the detection plane and the router see the identical lagged
    picture.
    """

    def __init__(self, engines: list,
                 policy: str | RouterPolicy = "join_shortest_queue",
                 staleness: float = 0.0, seed: int = 0,
                 plane=None,
                 view_link: LinkParams | None = None,
                 refresh_period: float = 2e-3,
                 nodes_per_replica: int = 1) -> None:
        if not engines:
            raise ValueError("need at least one engine replica")
        if nodes_per_replica < 1:
            raise ValueError("nodes_per_replica must be >= 1")
        self.engines = engines
        self.router = Router(len(engines), policy=policy,
                             staleness=staleness, seed=seed)
        self.plane = plane
        self.nodes_per_replica = nodes_per_replica
        self.refresh_period = refresh_period
        self._last_refresh = float("-inf")
        # zero-knob links draw no randomness, so the default front-end
        # stays deterministic; a jittery/lossy link consumes only its own
        # seeded stream
        self._view_rng = np.random.default_rng(seed ^ 0x51EF)
        # view snapshots are idempotent last-writer-wins datagrams, not a
        # sequenced stream — out-of-order arrival (view flapping) is part
        # of the channel, so ordered-stream clamping stays off
        self.view_link = ModeledLink(
            dataclasses.replace(view_link or LinkParams(delay=0.0),
                                ordered=False),
            self._view_rng)
        self._pending = EventBatchBuilder() if plane is not None else None

    # -- view pipeline ---------------------------------------------------

    def node_replica(self, node: int) -> int | None:
        """Map a cluster/detector node id to the replica (engine index)
        that owns it; None when the id is cluster-wide (-1) or out of
        range.  Detector findings carry *node* coordinates — indexing
        ``engines`` with one directly conflates the two spaces."""
        if node < 0:
            return None
        rep = node // self.nodes_per_replica
        return rep if rep < len(self.engines) else None

    def refresh(self, now: float = 0.0, force: bool = False) -> None:
        """Periodic view publication + delivery of matured snapshots."""
        if force or now - self._last_refresh >= self.refresh_period:
            self._last_refresh = now
            snaps = [
                engine_snapshot(eng, i, now,
                                node_base=i * self.nodes_per_replica)
                for i, eng in enumerate(self.engines)]
            self.view_link.send(now, snaps)
        for snaps in self.view_link.deliver(now):
            for snap in snaps:
                self.router.observe(snap)
            if self._pending is not None:
                # meta 0 == META_DIR_INGRESS: the front-end's per-replica
                # ingress queue depths, one columnar append per delivered
                # refresh (stamped with the snapshot time, as a DPU-side
                # collector would see it)
                ids = np.arange(len(snaps), dtype=np.int64)
                self._pending.add_columns(
                    np.full(len(snaps), snaps[0].ts),
                    EventKind.QUEUE_SAMPLE,
                    node=np.asarray([s.nodes[0].node if s.nodes
                                     else s.replica for s in snaps],
                                    np.int64),
                    depth=np.asarray([s.queue_depth for s in snaps],
                                     np.int64),
                    meta=0, replica=ids)

    def view_lag(self, now: float) -> float:
        """The measured router-view staleness (see Router.view_lag)."""
        return self.router.view_lag(now)

    def flush_telemetry(self) -> None:
        """Hand buffered front-end telemetry to the plane as one batch."""
        if self._pending is None or len(self._pending) == 0:
            return
        batch = self._pending.build(sort=True)
        self._pending.clear()
        self.plane.observe_batch(batch)

    def submit(self, req, now: float = 0.0) -> int:
        """Route one ServeRequest to a replica; returns the replica id."""
        self.refresh(now)
        replica = self.router.route(RequestInfo(
            flow=getattr(req, "req_id", -1),
            prompt_len=getattr(req, "prompt_len", 0),
            predicted_decode=float(getattr(req, "max_new_tokens", 0)),
            session=int(getattr(req, "session", -1))), now)
        if self._pending is not None:
            # node carries CLUSTER-node coordinates (the replica's first
            # node), matching the queue-sample rows — node-keyed detectors
            # must never see the two coordinate spaces mixed
            self._pending.add(
                ts=now, kind=EventKind.INGRESS_PKT,
                node=replica * self.nodes_per_replica,
                flow=getattr(req, "req_id", -1),
                size=2 * getattr(req, "prompt_len", 0),
                replica=replica)
        self.engines[replica].submit(req)
        self.flush_telemetry()
        return replica

    def submit_all(self, reqs, now: float = 0.0) -> list[int]:
        return [self.submit(r, now) for r in reqs]

    # ------------------------------------------------------------------
    # EngineControls — the router is a mitigation actuator too: the DPU
    # command bus (or the instant controller) can rebalance queued work
    # across replicas without touching any engine internals
    # ------------------------------------------------------------------

    def apply_action(self, action: str, node: int, detail: dict) -> bool:
        if action in ("rebalance_replicas", "rebalance_nodes"):
            # both routing actuators level the queued backlog; at the
            # live front-end the replica IS the node group
            self.rebalance(now=detail.get("now", 0.0))
            return True
        # per-engine knobs route through the explicit node -> replica map;
        # an id outside the cluster is refused, never silently mis-targeted
        rep = self.node_replica(node)
        if rep is None:
            return False
        eng = self.engines[rep]
        if hasattr(eng, "apply_action"):
            return bool(eng.apply_action(action, node, detail))
        return False

    def rebalance(self, now: float = 0.0) -> int:
        """Drain every replica's scheduler queue and re-deal the backlog
        round-robin starting from the shallowest replica; refreshes the
        router view so the next routed request sees the new state.
        Returns the number of requests moved."""
        backlog = []
        for eng in self.engines:
            q = eng.sched.queue
            backlog.extend(q)
            q.clear()
        backlog.sort(key=lambda r: getattr(r, "arrival", 0.0))
        order = sorted(range(len(self.engines)),
                       key=lambda i: len(self.engines[i].sched.running))
        for i, req in enumerate(backlog):
            self.engines[order[i % len(order)]].sched.submit(req)
        self.refresh(now, force=True)
        self.flush_telemetry()
        return len(backlog)
