"""Run one cell of BENCHMARK.json once, on one card:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's model with weights drawn on the card from the seed,
warms up, measures for ``--seconds``, checks the served tokens against the
plain float32 reference, and prints one JSON object as the last line of
standard output (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics, from host spans and ``torch.profiler``).  The
check's numbers and their limits are the last lines on standard error and
the last key of the result.  Without a CUDA card, or if JAX or the JAX
package was loaded, it exits with an error and prints no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark measures the card and runs "
              "nowhere else", file=sys.stderr)
        return 2
    from bench.cell import execute, load
    cell = load(args.workload, ROOT)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"imports {time.perf_counter() - T_START:.2f} s")
    device = torch.device("cuda", 0)
    result, _ = execute(cell, args.seed, args.seconds, bool(args.trace),
                        device, T_START, log)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark must not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    log(f"card: {result['device']['kind']}, {result['device']['power_limit']}")
    for name, v in result["check"].items():
        if isinstance(v, dict):
            log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
