"""Quickstart on the PyTorch port: examples/quickstart.py's pipeline, with
its configs, requests, seeds, engine settings and printed lines, through
``repro_torch``; the model runs on the card.

1. Build a model from the assigned-architecture registry.
2. Serve a few requests on the continuous-batching engine with the
   DPU-analog telemetry plane attached (prefill through the flash
   attention kernel, decode through the paged attention kernel).
3. Inject a pathology in the cluster simulator, watch the runbook
   detector fire, the §4.2 attributor localize it, and the §5 mitigation
   controller fix it.
4. Route a skewed workload across data-parallel replicas and watch the
   cross-replica router + the 3d closed loop at work.

The weights are drawn from seed 0 (the JAX package's init cannot be
reproduced in torch); the engine's report does not depend on them.  The
simulator runs on the host.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import dataclasses
import random

from repro_torch.configs import ARCHS
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, InferenceEngine, ServeRequest
from repro_torch.sim import SCENARIOS, run_scenario

ARCH = "llama3.2-3b"


def engine(model) -> InferenceEngine:
    """Step 2's engine: 4 slots of 128 tokens, 128 pages of 16."""
    return InferenceEngine(model, EngineConfig(
        max_slots=4, max_seq=128, n_pages=128, page_size=16))


def requests(vocab: int) -> list[ServeRequest]:
    """Ten requests, one every 3 ms: 8-31 prompt tokens, 4-11 new."""
    rng = random.Random(0)
    return [ServeRequest(
        req_id=i, arrival=i * 0.003,
        prompt=[rng.randrange(vocab) for _ in range(rng.randrange(8, 32))],
        max_new_tokens=rng.randrange(4, 12)) for i in range(10)]


def serve(eng: InferenceEngine) -> dict:
    """Step 2: the ten requests through ``eng``; its report."""
    return eng.run(requests(eng.model.cfg.vocab))


def pathology():
    """Step 3: a TP straggler in the simulator -> (scenario, metrics,
    plane)."""
    sc = SCENARIOS["tp_straggler"]
    metrics, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
    return sc, metrics, plane


def hot_replica():
    """Step 4: affinity pinning onto one replica, the loop off and on ->
    (scenario, metrics off, metrics on, plane on)."""
    sc = SCENARIOS["hot_replica"]
    off, _, _ = run_scenario(dataclasses.replace(sc.fault), sc.params,
                             sc.workload, mitigate=False)
    on, plane, _ = run_scenario(dataclasses.replace(sc.fault), sc.params,
                                sc.workload, mitigate=True)
    return sc, off, on, plane


def main(argv=None) -> InferenceEngine:
    """Runs the four steps and prints; returns step 2's engine."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (cuda or cpu)")
    args = ap.parse_args(argv)

    # ---- 1. a model from the zoo --------------------------------------
    cfg = ARCHS[ARCH].reduced()              # same family, smoke width
    model = build_model(cfg, args.device, seed=0)
    print(f"model: {cfg.name} ({cfg.family}), "
          f"full-size params would be {ARCHS[ARCH].param_count():.2e}")

    # ---- 2. serve with telemetry --------------------------------------
    eng = engine(model)
    report = serve(eng)
    print(f"served {report['completed']} requests, "
          f"{report['tokens_per_step']:.2f} tok/step, "
          f"p50 latency {report['p50_latency'] * 1e3:.1f} ms, "
          f"telemetry {report['telemetry']['events']} events, "
          f"{report['telemetry']['findings']} findings (healthy => 0)")

    # ---- 3. pathology -> detect -> attribute -> mitigate ---------------
    sc, metrics, plane = pathology()
    finding = next(f for f in plane.findings if f.name == "tp_straggler")
    att = next(a for a in plane.attributions
               if a.primary.name == "tp_straggler")
    print(f"\ninjected: TP straggler on node {sc.fault.straggler_node}")
    print(f"detected: '{finding.name}' on node {finding.node} "
          f"(severity {finding.severity}, "
          f"{metrics.first_finding_ts - sc.fault.start:.2f}s after onset)")
    print(f"attributed: locus={att.locus} — {att.narrative}")
    print(f"runbook directive: {finding.directive}")

    # ---- 4. data-parallel routing: hot replica -> rebalance -------------
    sc, off, on, plane = hot_replica()
    print(f"\ninjected: affinity pinning {sc.fault.hot_replica_frac:.0%} of "
          f"flows onto replica {sc.fault.hot_replica}")
    acts = [a.action for a in plane.actions]
    print(f"closed loop: actions={acts}")
    print(f"p99 latency {off.p(0.99) * 1e3:.0f} ms -> "
          f"{on.p(0.99) * 1e3:.0f} ms, completions "
          f"{off.completed} -> {on.completed}")
    return eng


if __name__ == "__main__":
    main()
