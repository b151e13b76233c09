"""The port's copy of the DPU control plane (``repro_torch.dpu``) against the
JAX package's (``repro.dpu``): the same scenario runs on each package and
everything it observes must be equal, exactly (both sides are numpy).

The scenarios follow tests/test_dpu.py, tests/test_chaos.py and
tests/test_election.py, with the wire's random knobs (jitter, drop,
corruption, duplication) on, so that the copies draw the same numbers from
the same generators in the same order."""

import random

import numpy as np
import pytest

from torch_parity import PACKAGES, batch_columns, package, plain

WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")


def _ns(pkg: str):
    return package(pkg, "core.attribution", "core.detectors", "core.events",
                   "core.mitigation", "core.telemetry", "dpu",
                   "dpu.policy")


def _finding(P, name="tp_straggler", ts=1.0, node=1, severity="warn",
             score=5.0):
    return P.Finding(name=name, table="3c", ts=ts, severity=severity,
                     node=node, device=-1, stage="s", root_cause="r",
                     directive="d", score=score)


def _att(P, name="tp_straggler", ts=1.0, node=1, severity="warn",
         confidence=0.9, score=5.0, locus="device_scheduling"):
    return P.Attribution(ts=ts, locus=locus, node=node,
                         confidence=confidence,
                         primary=_finding(P, name, ts, node, severity,
                                          score),
                         supporting=(), narrative="n")


def _batch(P, n, ts0=0.0, meta=None):
    b = P.EventBatchBuilder()
    for i in range(n):
        b.add(ts0 + i * 1e-5, int(P.EventKind.QUEUE_SAMPLE), i % 4,
              meta=P.META_TAP_DEBUG if meta is None else meta)
    return b.build(sort=True)


def _cmd(P, cmd_id=1, ts=0.0, action="rebalance_shards", node=1):
    return P.Command(cmd_id=cmd_id, ts=ts, action=action, node=node,
                     row_id="tp_straggler", locus="device_scheduling",
                     detail={})


class _Engine:
    """Records every actuation; accepts all of them."""

    def __init__(self):
        self.calls = []

    def apply_action(self, action, node, detail):
        self.calls.append((action, node))
        return True


def _drive(P, side, until, dt=2e-3, rate=4, start=0.0):
    """A steady healthy tap into a sidecar or watchdog, pumped each step;
    the state the loop reports, every 50 ms."""
    t, seen = start, []
    k = 0
    while t < until:
        side.observe_batch(_batch(P, rate, ts0=t))
        side.advance(t)
        if k % 25 == 0:
            seen.append((round(t, 6), plain(side.report())))
        t += dt
        k += 1
    return seen


def _plane_record(plane) -> dict:
    rep = {k: v for k, v in plane.report().items() if k not in WALL_CLOCK}
    return {"report": plain(rep), "findings": plain(plane.findings),
            "attributions": plain(plane.attributions),
            "actions": plain(plane.actions)}


# ----------------------------------------------------------------------
# scenarios: each returns everything it observed, as plain data
# ----------------------------------------------------------------------

def transport_chaos(P):
    out = []
    for ordered in (True, False):
        link = P.ModeledLink(
            P.LinkParams(delay=1e-3, jitter=2e-3, drop_p=0.2, corrupt_p=0.1,
                         duplicate_p=0.15, partition_start=0.05,
                         partition_duration=0.01, ordered=ordered),
            np.random.default_rng(11), corruptor=lambda p: ("rot", p))
        sent = [link.send(i * 5e-4, i) for i in range(200)]
        inflight = sorted(link._inflight)   # (arrival, seq, payload)
        got = [(k, link.deliver(k * 1e-3)) for k in range(1, 120)]
        out.append({"sent": sent, "inflight": plain(inflight), "got": got,
                    "counts": (link.sent, link.dropped, link.delivered,
                               link.partition_dropped, link.corrupted,
                               link.duplicated),
                    "next_draw": link.rng.random()})
        assert link.dropped and link.corrupted and link.duplicated
    # the tap fan-out: every consumer a frame of its own
    legs = [[], []]

    class Leg:
        def __init__(self, i):
            self.i = i

        def observe_batch(self, b):
            legs[self.i].append(batch_columns(b))
            b.batch_seq = 7 + self.i
    fan = P.TapFanout(Leg(0), Leg(1))
    for k in range(3):
        fan.observe_batch(_batch(P, 5, ts0=k * 1e-3))
    out.append({"legs": legs, "forked": fan.forked})
    return out


def budget_shed(P):
    out = []
    ring = P.DPUBudget(events_per_s=1e9, ring_events=100)
    out.append([ring.offer(_batch(P, n)) for n in (80, 50, 10)])
    out.append((ring.events_shed, ring.backlog, ring.occupancy()))
    paced = P.DPUBudget(events_per_s=1000.0, ring_events=120)
    for k in range(6):
        out.append(paced.offer(_batch(P, 40, ts0=float(k))))
        for t in (0.0, 0.013, 0.0301, 0.2):
            out.append([b.ts.tolist()
                        for b in paced.drain(k * 0.25 + t)])
        out.append((paced.backlog, paced.events_offered,
                    paced.events_accepted, paced.events_shed,
                    paced.events_processed, paced.occupancy()))
    paced.offer(_batch(P, 60))
    out.append((paced.crash(), paced.backlog, paced.drain(5.0)))
    return plain(out)


def policy_engine(P):
    out = []
    pol = P.PolicyEngine(confirmations=2)
    pol.observe(_att(P, ts=1.0))
    out.append(pol.decide(1.0))
    pol.observe(_att(P, ts=2.0))
    out.append(pol.decide(2.0))
    # cooldown, flap damping, quarantine
    pol = P.PolicyEngine(confirmations=1, cooldown=0.2, flap_window=10.0,
                         flap_limit=2, flap_backoff=2.0)
    for k in range(10):
        t = 1.0 + k * 0.3
        if k == 6:
            pol.quarantine(t + 0.5)
        pol.observe(_att(P, ts=t, severity="critical"))
        out.append(pol.decide(t))
    out.append(pol.effective_cooldown(("rebalance_shards", 1), 4.0))
    # conflict arbitration inside one group on one node
    pol = P.PolicyEngine(confirmations=1)
    for name, sev in (("burst_admission_backlog", "warn"),
                      ("burst_admission_backlog", "warn"),
                      ("ingress_egress_bandwidth_saturation", "critical")):
        pol.observe(_att(P, name, ts=1.0, node=0, severity=sev,
                         locus="ingress_path"))
    out.append(pol.decide(1.0))
    # quorum escalation after the dwell, and its re-arm
    pol = P.PolicyEngine(confirmations=2, quorum=3, quorum_dwell=1.0,
                         cooldown=5.0)
    for ts, nodes in ((1.0, range(4)), (8.0, range(10, 14))):
        for node in nodes:
            pol.observe(_att(P, "d2h_return_bottleneck", ts=ts, node=node,
                             confidence=0.6, locus="pcie_transfer"))
        for dt in (0.0, 0.5, 1.1, 2.0):
            out.append(pol.decide(ts + dt))
    out.append(pol.drain_escalations())
    # a low-confidence attribution is filtered
    pol2 = P.PolicyEngine(confirmations=1, min_confidence=0.5)
    pol2.observe(_att(P, ts=1.0, severity="critical", confidence=0.4))
    out.append(pol2.decide(1.0))
    out.append((pol.issued, pol.suppressed, pol2.suppressed))
    assert any(out)
    return plain(out)


def command_bus(P):
    out = []
    cases = [
        dict(down=P.LinkParams(delay=1e-3, jitter=1e-3, drop_p=0.5),
             ack=P.LinkParams(delay=1e-3, drop_p=0.3),
             ack_timeout=3e-3, max_retries=6, stale_after=10.0),
        dict(down=P.LinkParams(delay=1e-3, duplicate_p=0.5),
             ack=P.LinkParams(delay=1e-3, drop_p=1.0),
             ack_timeout=2e-3, max_retries=5, stale_after=10.0),
        dict(down=P.LinkParams(delay=0.2), stale_after=0.1),
        dict(down=P.LinkParams(delay=1e-3, drop_p=1.0), ack_timeout=1e-3,
             max_retries=3, stale_after=10.0),
    ]
    for seed, kw in enumerate(cases):
        eng = _Engine()
        bus = P.CommandBus(eng, np.random.default_rng(seed), **kw)
        for k in range(4):
            bus.send(_cmd(P, cmd_id=k + 1, ts=k * 2e-3), k * 2e-3)
        bus.send(_cmd(P, cmd_id=-1, ts=0.0, action=P.PING_ACTION), 0.0)
        recs = [bus.advance(k * 1e-3) for k in range(1, 300)]
        out.append({"records": plain(recs), "calls": eng.calls,
                    "stats": plain(bus.stats),
                    "backoff": [bus.backoff_delay(a) for a in range(5)]})
    # the newer command applies first; the older straggler is dropped
    eng = _Engine()
    bus = P.CommandBus(eng, np.random.default_rng(0),
                       down=P.LinkParams(delay=0.0))
    bus.send(_cmd(P, cmd_id=2, ts=0.01), 0.01)
    bus.advance(0.02)
    bus.send(_cmd(P, cmd_id=1, ts=0.015), 0.03)
    bus.advance(0.04)
    out.append({"calls": eng.calls, "stats": plain(bus.stats)})
    return out


def sidecar_storm(P):
    plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
    side = P.DPUSidecar(
        plane, P.DPUParams(events_per_s=5_000, ring_events=512,
                           uplink=P.LinkParams(delay=1e-3, jitter=5e-4,
                                               drop_p=0.02, corrupt_p=0.01,
                                               duplicate_p=0.01),
                           downlink=P.LinkParams(delay=1e-3, drop_p=0.1),
                           ping_every=0.05),
        seed=3, mitigate=True)
    eng = _Engine()
    side.bind(eng)
    seen = []
    for step in range(600):
        t = step * 1e-3
        side.observe_batch(_batch(P, 50, ts0=t))
        side.advance(t)
        if step % 50 == 0:
            seen.append(plain(side.report()))
    assert "dpu_saturation" in {f.name for f in plane.findings}
    return {"seen": seen, "calls": eng.calls, "plane": _plane_record(plane),
            "rng": side.rng.random()}


def sidecar_crash_restart(P):
    plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
    side = P.DPUSidecar(plane, P.DPUParams(
        crash_at=0.5, restart_after=0.2,
        uplink=P.LinkParams(delay=1e-3, jitter=1e-3, drop_p=0.05)),
        mitigate=False, seed=5)
    seen = _drive(P, side, 1.2)
    rec = {"seen": seen, "crashed": side.crashed, "restarts": side.restarts,
           "heartbeat": side.heartbeat_ts,
           "guard": (side.guard.gaps, side.guard.dirty)}
    side.resync(1.2)
    rec["after_resync"] = side.guard.dirty
    rec["plane"] = _plane_record(plane)
    assert side.restarts == 1
    return rec


def election(P):
    holders = ("primary", "standby", "host")
    rng = random.Random(4)
    arb = P.ElectionArbiter(P.LeaseParams(lease_s=0.12))
    for h in holders:
        arb.register(h)
    now = 0.0
    arb.grant("primary", now)
    seen = []
    for _ in range(300):
        op = rng.choice(["renew", "renew_lost", "revoke", "grant",
                         "grant_lost", "tick"])
        holder = rng.choice(holders)
        now += rng.uniform(0.0, 0.3)
        if op == "renew":
            r = arb.renew(now)
        elif op == "renew_lost":
            r = arb.renew(now, delivered=False)
        elif op == "revoke":
            r = arb.revoke(holder, now)
        elif op == "grant":
            r = arb.grant(holder, now)
        elif op == "grant_lost":
            r = arb.grant(holder, now, delivered=False)
        else:
            r = None
        seen.append((op, holder, plain(r), arb.valid_holders(now),
                     [arb.can_promote(h, now) for h in holders],
                     plain(arb.report())))
    # fencing: a stale term's command is refused and recorded
    reg = arb.registry
    stale = P.Command(cmd_id=99, ts=now, action="rebalance_shards", node=1,
                      row_id="r", locus="l", term=max(reg.term - 1, 0))
    seen.append((reg.admit(stale, now), plain(reg)))
    return seen


def watchdog_failover(P):
    plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
    side = P.DPUSidecar(plane, P.DPUParams(crash_at=0.5, restart_after=0.3),
                        mitigate=False)
    wd = P.Watchdog(side, P.WatchdogParams(), mitigate=False)
    seen = _drive(P, wd, 1.2)
    assert wd.failovers == 1 and wd.failbacks == 1
    seen.append((wd.force_failover(1.25), wd.state, wd.failover_ts))
    seen.append(plain(wd.standby.findings))
    return seen


def watchdog_standby(P):
    out = []
    for primary_kw, standby_kw, until in (
            (dict(crash_at=0.5), {}, 1.0),
            (dict(crash_at=0.5, restart_after=0.2), {}, 1.5),
            (dict(crash_at=0.5), dict(crash_at=0.5), 1.2)):
        plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
        side = P.DPUSidecar(plane, P.DPUParams(**primary_kw),
                            mitigate=True)
        sb_plane = P.TelemetryPlane(n_nodes=4, mitigate=False)
        standby = P.DPUSidecar(sb_plane, P.DPUParams(**standby_kw),
                               mitigate=True, seed=1)
        wd = P.Watchdog(side, P.WatchdogParams(), mitigate=True,
                        standby=standby)
        eng = _Engine()
        wd.bind(eng)
        seen = _drive(P, wd, until)
        out.append({"seen": seen, "state": wd.state,
                    "promotions": wd.promotions,
                    "registry": plain(wd.arbiter.registry),
                    "calls": eng.calls,
                    "findings": plain(wd.findings)})
    assert out[0]["promotions"] == 1
    return out


SCENARIOS = {f.__name__: f for f in (
    transport_chaos, budget_shed, policy_engine, command_bus, sidecar_storm,
    sidecar_crash_restart, election, watchdog_failover, watchdog_standby)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dpu_copy_matches_reference(scenario):
    ref, port = (SCENARIOS[scenario](_ns(pkg)) for pkg in PACKAGES)
    assert port == ref


def test_dpu_exports_match_reference():
    import repro.dpu
    import repro_torch.dpu
    assert repro_torch.dpu.__all__ == repro.dpu.__all__
