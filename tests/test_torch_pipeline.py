"""The port's GPipe schedule (``parallel/pipeline.py``) and elastic remesh
(``training/elastic.py``) on 8 gloo CPU ranks, as the JAX package's own
cases (tests/test_sharding_dryrun.py) run them on 8 forced host devices:
a (2, 4) pod x model mesh with tanh stages against the sequential
computation at 1e-5, ``bubble_fraction(2, 4) == 0.2``; a (4, 2) data x
model mesh losing two hosts, ``arange(64)`` kept exactly on the (2, 2)
mesh of the survivors, ``micro_scale == 2``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(*args: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=8", __file__, *args],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return json.loads(line[-1])


def test_pipeline_parallel_over_pod_axis():
    out = _run("pipeline")
    assert out["max_err"] <= 1e-5, out
    assert out["ranks_agree"]


def test_bubble_fraction():
    from repro_torch.parallel.pipeline import bubble_fraction
    assert abs(bubble_fraction(2, 4) - 0.2) < 1e-9
    assert bubble_fraction(1, 8) == 0.0


def test_plan_remesh_matches_the_reference():
    from types import SimpleNamespace

    from repro.training.elastic import plan_remesh as jplan
    from repro_torch.training.elastic import plan_remesh
    for shape, failed in (((4, 2), 2), ((16, 16), 3), ((8, 4), 7)):
        mesh = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
        got, want = plan_remesh(mesh, failed), jplan(mesh, failed)
        assert (got.old_shape, got.new_shape, got.dp_scale,
                got.micro_scale) == (want.old_shape, want.new_shape,
                                     want.dp_scale, want.micro_scale)
    with pytest.raises(ValueError):
        plan_remesh(SimpleNamespace(shape={"data": 2, "model": 2}), 2)


def test_elastic_remesh_preserves_values():
    out = _run("elastic")
    assert out["new_shape"] == {"data": 2, "model": 2}
    assert out["micro_scale"] == 2
    assert out["exact"] and out["placements"] == ["S(0)", "S(1)"]


# ----------------------------------------------------------------------
# workers (run under torch.distributed.run)
# ----------------------------------------------------------------------

def _pipeline_worker() -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "model"))
    n_stages, n_micro, mb, d = 2, 4, 2, 16
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((n_stages, d, d), generator=gen) * 0.1
    x = torch.randn((n_micro, mb, d), generator=gen)
    stage = mesh.get_local_rank("pod")
    outs = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"]),
                            {"w": w[stage]}, x, mesh=mesh, axis="pod")
    want = x
    for s in range(n_stages):
        want = torch.tanh(want @ w[s])
    gathered = [torch.empty_like(outs) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, outs)
    agree = all(torch.equal(g, gathered[0]) for g in gathered)
    return {"max_err": float((outs - want).abs().max()),
            "ranks_agree": agree}


def _elastic_worker() -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import MeshRules, placements
    from repro_torch.training.elastic import plan_remesh, remesh
    old = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    rules = MeshRules(old)
    full = {"wq": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    specs = rules.param_specs(full)
    params = {k: distribute_tensor(v, old, placements(old, specs[k]))
              for k, v in full.items()}
    plan = plan_remesh(old, failed_nodes=2)
    d, m = plan.new_shape["data"], plan.new_shape["model"]
    # the survivors: the first d rows of the (data, model) grid
    new_mesh = DeviceMesh("cpu", torch.arange(d * m).view(d, m),
                          mesh_dim_names=("data", "model"))
    mine = dist.get_rank() < d * m
    new, _ = remesh(params, rules, new_mesh if mine else None)
    ok = torch.tensor([1.0])
    pl = []
    if mine:
        got = new["wq"].full_tensor()
        ok[0] = float(torch.equal(got, full["wq"]))
        pl = [str(p) for p in new["wq"].placements]
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return {"new_shape": plan.new_shape, "micro_scale": plan.micro_scale,
            "exact": bool(ok[0] == 1.0), "placements": pl}


if __name__ == "__main__":
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import start_group
    start_group("cpu")
    result = {"pipeline": _pipeline_worker,
              "elastic": _elastic_worker}[sys.argv[1]]()
    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(result), flush=True)
