"""The port's copy of the cross-replica router (``repro_torch.serving.
router``) against the JAX package's: every policy on the same views and
requests with the same seeds, the ReplicaSet front-end over stub engines
(its view riding a lossy modeled link, its telemetry into a plane), and
``engine_snapshot`` of a port engine and of a JAX engine stopped at the same
step of the same run.  Every routing decision must be equal, exactly."""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_parity import PACKAGES, batch_columns, package, plain  # noqa: E402

WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")


def _ns(pkg: str):
    return package(pkg, "serving.router", "dpu.transport", "core.telemetry")


def _snap(P, replica, ts, depth, nodes=(), work=None, kv=0.0):
    return P.ReplicaSnapshot(replica=replica, ts=ts, queue_depth=depth,
                             active=depth % 3, slots=8, kv_occupancy=kv,
                             expected_work=float(depth if work is None
                                                 else work),
                             nodes=nodes)


def _nodes(P, replica, rng, npr=2):
    return tuple(P.NodeSnapshot(node=replica * npr + i,
                                queue_depth=rng.randrange(0, 6),
                                active=rng.randrange(0, 3), slots=8,
                                dev_active=tuple(rng.randrange(0, 3)
                                                 for _ in range(4)))
                 for i in range(npr))


def policies(P):
    """Each policy over a churning, partly out-of-order view; one stale
    router.  Decisions, counts and lags."""
    out = {}
    for policy in sorted(P.POLICIES):
        for staleness in (0.0, 0.05):
            rng = random.Random(5)
            router = P.Router(4, policy=policy, staleness=staleness, seed=1)
            for i in range(240):
                now = 0.004 * i
                if i % 9 == 0:
                    for r in range(4):
                        ts = now - rng.choice((0.0, 0.0, 0.02, 0.07))
                        router.observe(_snap(
                            P, r, ts, rng.randrange(0, 30),
                            _nodes(P, r, rng), rng.uniform(0, 60),
                            rng.random()))
                router.route_ex(P.RequestInfo(
                    flow=i, prompt_len=rng.randrange(8, 64),
                    predicted_decode=float(rng.randrange(1, 200)),
                    session=rng.randrange(-1, 12)), now)
            out[(policy, staleness)] = {
                "decisions": plain(router.decisions),
                "routed": router.routed_per_replica,
                "imbalance": router.imbalance(),
                "lag": router.view_lag(1.0),
                "tree": plain(router.view.tree(now=1.0)),
                "policy": plain(router.policy)}
    return plain(out)


class _Sched:
    def __init__(self, slots):
        self.queue = []
        self.running = {}
        self.cfg = dataclasses.make_dataclass("C", ["max_slots"])(
            max_slots=slots)
        self.submit = self.queue.append


class _Pool:
    def __init__(self, occ):
        self.occ = occ

    def occupancy(self):
        return self.occ


class _Engine:
    """The duck type engine_snapshot reads, and an actuator."""

    def __init__(self, occ):
        self.sched = _Sched(8)
        self.pool = _Pool(occ)
        self.calls = []

    def submit(self, req):
        self.sched.queue.append(req)

    def apply_action(self, action, node, detail):
        self.calls.append((action, node))
        return True


@dataclasses.dataclass
class _Req:
    req_id: int
    max_new_tokens: int = 8
    tokens_out: int = 0
    prompt_len: int = 16
    arrival: float = 0.0


def replica_set(P):
    """Three stub engines behind hierarchical JSQ; the view over a jittery,
    lossy unordered link; front-end telemetry into a plane; requests start
    running, a rebalance and per-node actions."""
    out = []
    batches = []
    plane = P.TelemetryPlane(n_nodes=6, mitigate=False)
    observe = plane.observe_batch

    def tap(batch):
        batches.append(batch_columns(batch))
        return observe(batch)
    plane.observe_batch = tap
    engines = [_Engine(occ) for occ in (0.7, 0.2, 0.5)]
    rs = P.ReplicaSet(engines, policy="hierarchical_jsq", seed=3,
                      plane=plane,
                      view_link=P.LinkParams(delay=2e-3, jitter=4e-3,
                                             drop_p=0.2),
                      refresh_period=3e-3, nodes_per_replica=2)
    rng = random.Random(9)
    for i in range(90):
        now = i * 1e-3
        out.append(rs.submit(_Req(i, max_new_tokens=rng.randrange(1, 50),
                                  arrival=now), now))
        if i % 7 == 0:     # the engines admit a request each
            for e in engines:
                if e.sched.queue:
                    slot = len(e.sched.running)
                    e.sched.running[slot] = e.sched.queue.pop(0)
                    e.sched.running[slot].tokens_out = rng.randrange(0, 4)
        if i == 60:
            out.append(rs.apply_action("rebalance_replicas", -1,
                                       {"now": now}))
    for node in (-1, 0, 3, 5, 6):
        out.append((node, rs.node_replica(node),
                    rs.apply_action("compress_kv", node, {})))
    out.append([e.calls for e in engines])
    out.append([[r.req_id for r in e.sched.queue] for e in engines])
    out.append([plain(P.engine_snapshot(e, i, 0.1, node_base=2 * i))
                for i, e in enumerate(engines)])
    out.append((rs.view_link.sent, rs.view_link.dropped,
                rs.view_lag(0.1), plain(rs.router.decisions)))
    rep = {k: v for k, v in plane.report().items() if k not in WALL_CLOCK}
    out.append((batches, plain(rep)))
    assert rs.view_link.dropped > 0 and batches
    return plain(out)


SCENARIOS = {f.__name__: f for f in (policies, replica_set)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_copy_matches_reference(scenario):
    ref, port = (SCENARIOS[scenario](_ns(pkg)) for pkg in PACKAGES)
    assert port == ref


def test_serving_exports_match_reference():
    import repro.serving
    import repro_torch.serving
    assert repro_torch.serving.__all__ == repro.serving.__all__
    with pytest.raises(ValueError):
        repro_torch.serving.make_policy("no_such_policy")


def test_engine_snapshot_of_port_and_jax_engines():
    """The same requests into a port engine and a JAX engine, both stopped
    after 9 steps with slots running and requests queued: equal snapshots
    (scheduling does not depend on the weights)."""
    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as jax_build_model
    from repro.serving import EngineConfig as JConfig
    from repro.serving import InferenceEngine as JEngine
    from repro.serving import ServeRequest as JRequest
    from repro.serving.router import engine_snapshot as jax_snapshot
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, InferenceEngine
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.router import engine_snapshot

    rng = random.Random(2)
    specs = [(i, i * 0.001, [1] * rng.randrange(8, 30), rng.randrange(4, 20))
             for i in range(10)]
    kw = dict(max_slots=4, max_seq=64, n_pages=64, page_size=16)
    jm = jax_build_model(JARCHS["qwen3-0.6b"].reduced())
    jeng = JEngine(jm, jm.init(jax.random.key(0)), JConfig(**kw))
    jeng.run([JRequest(*s) for s in specs], max_steps=9)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = InferenceEngine(build_model(ARCHS["qwen3-0.6b"].reduced(),
                                          device="cpu", seed=0),
                              EngineConfig(**kw))
        eng.run([ServeRequest(*s) for s in specs], max_steps=9)
    finally:
        torch.set_num_threads(n)
    snaps = [plain(snap(e, 1, e.clock, node_base=3))
             for snap, e in ((jax_snapshot, jeng), (engine_snapshot, eng))]
    assert snaps[1] == snaps[0]
    _, fields = snaps[1]
    assert fields["queue_depth"] > 0 and fields["active"] == 4
    assert np.isclose(fields["kv_occupancy"], eng.pool.occupancy())
