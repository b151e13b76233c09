"""Serving launcher: continuous-batching engine + DPU-analog telemetry.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 24 --rate 200 --report

The model runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the kernels' plain versions on the CPU.  The report
does not depend on the weights: scheduling, event sizes and the clock
depend only on the requests' lengths.
"""

from __future__ import annotations

import argparse
import json
import random

from repro_torch.configs import ARCHS
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, InferenceEngine, ServeRequest


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=250.0,
                    help="request arrivals per second")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--static-batching", action="store_true",
                    help="start in the pathological no-remap mode")
    ap.add_argument("--no-mitigate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", action="store_true",
                    help="dump the full JSON report")
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (cuda or cpu)")
    args = ap.parse_args()

    cfg = ARCHS[args.arch].reduced()
    model = build_model(cfg, args.device, args.seed)
    engine = InferenceEngine(model, EngineConfig(
        max_slots=args.slots, max_seq=args.max_seq,
        n_pages=args.max_seq * args.slots // 8, page_size=16,
        mitigate=not args.no_mitigate))
    if args.static_batching:
        engine.sched.set_continuous(False)

    rng = random.Random(args.seed)
    t = 0.0
    reqs = []
    for i in range(args.requests):
        reqs.append(ServeRequest(
            req_id=i, arrival=t,
            prompt=[rng.randrange(cfg.vocab)
                    for _ in range(rng.randrange(8, args.max_seq // 3))],
            max_new_tokens=rng.randrange(4, args.max_seq // 4)))
        t += rng.expovariate(args.rate)

    rep = engine.run(reqs, max_steps=args.requests * args.max_seq)
    print(f"[serve] {cfg.name}: {rep['completed']}/{args.requests} done, "
          f"{rep['tokens_per_step']:.2f} tok/step, "
          f"p50 {rep['p50_latency'] * 1e3:.1f} ms, "
          f"p99 {rep['p99_latency'] * 1e3:.1f} ms, "
          f"ttft p50 {rep['p50_ttft'] * 1e3:.1f} ms")
    tel = rep.get("telemetry", {})
    print(f"[telemetry] {tel.get('events', 0)} events, "
          f"findings {tel.get('findings_by_row', {})}, "
          f"actions {[a for _, a, _ in tel.get('actions', [])]}")
    if args.report:
        print(json.dumps(rep, indent=1, default=str))


if __name__ == "__main__":
    main()
