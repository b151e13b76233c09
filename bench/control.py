"""Readings from which a cell's check limits are set (``bench/checks``):
for each seed, a run of the cell through the benchmark's own path
(``bench.cell.execute``), then the check's numbers for the program's served
tokens and for the control, the float32 reference computed in float8 put in
the program's place, on the same sampled requests (each also over the
bfloat16 baseline's mean gap).  All seeds run in one
process, one after another.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 30
        [--no-control]

Prints one JSON line per seed.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device, control: bool,
             log=lambda *a: None) -> dict:
    from bench import check
    from bench.cell import execute
    t0 = time.perf_counter()
    result, checked = execute(cell, seed, seconds, False, device, t0, log,
                              control=control)
    out = {"seed": seed, "correct": result["correct"],
           "requests": len(checked.picked),
           "program": check.numbers(checked.program, checked.baseline),
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
    # each request's prefill bucket, prompt, tokens, mean and widest gap
    out["per_request"] = [[r.bucket, len(r.prompt), len(g),
                           float(g.mean()), float(g.max())]
                          for r, g in zip(checked.picked, checked.program)]
    if control:
        out["control"] = check.numbers(checked.control, checked.baseline)
        out["control_per_request"] = [[float(g.mean()), float(g.max())]
                                      for g in checked.control]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from bench.cell import load
    cell = load(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.seconds, device,
                       not args.no_control,
                       lambda m: print(m, file=sys.stderr, flush=True))
        out["workload"] = args.workload
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
