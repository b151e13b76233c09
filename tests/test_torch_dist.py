"""Sharded training and decoding in the port on gloo process groups of CPU
ranks (``torch.distributed.run`` subprocesses, one thread each), against
the same runs unsharded in this process.

- ``python -m repro_torch.launch.train --mesh 2,2`` on 4 ranks trains
  reduced qwen3-0.6b, qwen2-moe-a2.7b and zamba2-7b in f32: every step's
  loss equals the unsharded launcher's within 1e-5 (relative; the hybrid's
  gradients, of norm ~60, sum in another order across ranks).
- A 2-rank 'model' mesh decodes through the sequence-sharded cache (each
  rank attends its slice and the slices merge by log-sum-exp): logits
  equal the unsharded decode's within 1e-4, for the paged path (qwen3) and
  the windowed path (h2o-danube, the kpos-masked softmax)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--steps", "2", "--batch", "8", "--seq", "32", "--micro", "2",
         "--device", "cpu"]


def _run(nproc: int, *args: str, timeout: int = 240) -> dict:
    """This file as a worker on ``nproc`` gloo ranks; rank 0's JSON."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", __file__, *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return json.loads(line[-1])


def _losses(argv) -> list[float]:
    from repro_torch.launch import train as tl
    trainer, data = tl.setup(tl.parse_args(argv))
    return [h["loss"] for h in trainer.run(data)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "zamba2-7b"])
def test_mesh_2x2_training_gives_the_unsharded_losses(arch):
    torch.set_num_threads(1)
    want = _losses(["--arch", arch, *TRAIN])
    got = _run(4, "train", arch)["losses"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-3-4b"])
def test_model_axis_decode_merges_the_cache_slices(arch):
    out = _run(2, "decode", arch)
    assert out["max_err"] <= 1e-4, out
    assert out["cache_err"] <= 1e-5, out
    assert out["steps"] == 6


# ----------------------------------------------------------------------
# workers (run under torch.distributed.run)
# ----------------------------------------------------------------------

def _train_worker(arch: str) -> dict:
    from repro_torch.launch import train as tl
    losses = _losses(["--arch", arch, *TRAIN, "--mesh", "2,2"])
    return {"losses": losses}


def _decode_worker(arch: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import start_group
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import (MeshRules, distribute_model,
                                               full)
    start_group("cpu")
    rules = MeshRules(init_device_mesh("cpu", (1, 2),
                                       mesh_dim_names=("data", "model")))
    cfg = ARCHS[arch].reduced()
    ref = build_model(cfg, device="cpu", seed=3)
    sh = distribute_model(build_model(cfg, device="cpu", seed=3), rules)
    gen = torch.Generator().manual_seed(0)
    b, s, steps = 4, 12, 6
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    c1, c2 = ref.init_cache(b, 64), sh.init_cache(b, 64)
    l1, c1 = ref.prefill(prompt, c1)
    l2, c2 = sh.prefill(prompt, c2, shard=rules)
    errs = [float((l1 - full(l2)).abs().max())]
    for _ in range(steps):
        tok = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
        l1, c1 = ref.decode_step(tok, c1)
        l2, c2 = sh.decode_step(tok, c2, shard=rules)
        errs.append(float((l1 - full(l2)).abs().max()))
    cache_err = max(float((c1[k].float() - full(c2[k]).float()).abs().max())
                    for k in ("k", "v", "kpos", "pos"))
    return {"max_err": max(errs), "cache_err": cache_err, "steps": steps}


if __name__ == "__main__":
    torch.set_num_threads(1)
    kind, arch = sys.argv[1], sys.argv[2]
    result = {"train": _train_worker, "decode": _decode_worker}[kind](arch)
    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(result), flush=True)
