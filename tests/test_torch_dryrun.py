"""The port's dry-run and roofline (``launch/dryrun.py``, ``launch/
roofline.py``): each family's train and decode cells on an 8-rank fake
process group (reduced configs, smoke shapes), and the counting itself.

The fake backend comes from a module of torch's testing package
(``torch.testing._internal.distributed.fake_pg``); the first test pins it.
Each fake group runs in a subprocess, so no process group is left in the
test process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["qwen3-0.6b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "seamless-m4t-large-v2", "zamba2-7b", "xlstm-125m"]
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "lower_s",
               "compile_s", "flops_per_device", "bytes_per_device",
               "collective_bytes", "memory", "rules", "params_total",
               "params_active", "tokens"}


def _worker(*args: str, env: dict | None = None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", **(env or {})}
    proc = subprocess.run([sys.executable, __file__, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_fake_backend_is_there():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore is not None
    out = _worker("fake")
    assert out == {"backend": "fake", "world": 256, "mesh": [16, 16]}


@pytest.fixture(scope="module")
def cells():
    return _worker("cells")


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_each_family_dry_runs_on_a_fake_mesh(cells, arch, kind):
    rec = cells[f"{arch}/{kind}"]
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert rec["ok"] and rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["compile_s"] == 0.0
    assert set(rec["collective_bytes"]) <= {
        "all-gather", "reduce-scatter", "all-reduce", "all-to-all",
        "collective-permute"}
    assert sum(rec["collective_bytes"].values()) == pytest.approx(
        sum(rec["collective_bytes_by_axis"].values()))


@pytest.mark.parametrize("arch", FAMILIES)
def test_calibration_reproduces_the_production_count(cells, arch):
    """The eager count visits every layer, so the JAX package's depth
    calibration must give the production count back: exactly for FLOPs,
    and for bytes in every family but the hybrid's train step, where the
    shared block's weight gradients are summed over its applications (the
    first application adds nothing), so its bytes are not linear in the
    applications and the solve misses them by a few percent."""
    check = cells[f"{arch}/calibration"]
    assert check["flops_per_device"]["rel_diff"] == 0.0, check
    rel = check["bytes_per_device"]["rel_diff"]
    if arch == "zamba2-7b":
        assert rel < 0 and abs(rel) < 0.05, check
    else:
        assert rel == 0.0, check


def test_one_rank_mesh_counts_what_flop_counter_counts(cells):
    got = cells["one_rank"]
    assert got["dryrun"] == got["flop_counter"] > 0


def test_column_then_row_parallel_is_one_all_reduce(cells):
    got = cells["tp_pair"]
    b, s, d = got["shape"]
    assert got["collectives"] == [["all_reduce", b * s * d * 4, "model"]]


def test_model_flops_matches_the_reference():
    code = ("import json; from repro.configs import ARCHS, SHAPES; "
            "from repro.launch.roofline import model_flops; "
            "print(json.dumps({f'{a}/{s}': model_flops(ARCHS[a], SHAPES[s])"
            " for a in ARCHS for s in SHAPES}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.roofline import model_flops
    got = {f"{a}/{s}": model_flops(ARCHS[a], SHAPES[s])
           for a in ARCHS for s in SHAPES}
    assert got == want


def test_roofline_constants_are_the_h100s():
    from repro_torch.launch import roofline
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9 and roofline.NIC_BW == 50e9
    src = Path(roofline.__file__).read_text()
    for tpu in ("197e12", "819e9", "v5e"):
        assert tpu not in src


# ----------------------------------------------------------------------
# workers
# ----------------------------------------------------------------------

def _fake() -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, start_group
    start_group(fake_world=256)
    mesh = make_production_mesh()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": list(mesh.shape)}


def _cells() -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import start_group
    from repro_torch.models import build_model
    from repro_torch.models.model import ShapeSpec
    from repro_torch.parallel.sharding import MeshRules, placements
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                adamw_update)
    start_group(fake_world=8)
    mesh = DeviceMesh("cpu", torch.arange(8).view(2, 4),
                      mesh_dim_names=("data", "model"))
    SHAPES["t"] = ShapeSpec("t", "train", 32, 8)
    SHAPES["d"] = ShapeSpec("d", "decode", 32, 8)
    out = {}
    for arch in FAMILIES:
        ARCHS[arch] = ARCHS[arch].reduced(name=arch)
        for kind, shape in (("train", "t"), ("decode", "d")):
            out[f"{arch}/{kind}"] = dryrun.lower_cell(arch, shape, mesh)
        out[f"{arch}/calibration"] = roofline.analyze_cell(
            arch, "t", mesh, prod_record=out[f"{arch}/train"]
        )["calibration_check"]
    # one rank: the dry-run's count is FlopCounterMode's on the plain step
    one = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.long),
                     mesh_dim_names=("data", "model"))
    arch = "qwen3-0.6b"
    counted = dryrun.lower_cell(arch, "t", one)["flops_per_device"]
    model = build_model(ARCHS[arch], device="meta")
    params = dict(model.decoder.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    batch = model.input_specs(SHAPES["t"])["batch"]
    opt = adamw_init(params)
    with FlopCounterMode(display=False) as fc:
        loss = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        adamw_update(AdamWConfig(), grads, opt, params)
    out["one_rank"] = {"dryrun": counted,
                      "flop_counter": fc.get_total_flops()}
    # a column-parallel product then a row-parallel one
    rules = MeshRules(mesh)
    b, s, d, f = 8, 16, 32, 64
    x = distribute_tensor(torch.randn(b, s, d, device="meta"), mesh,
                          placements(mesh, ("data", None, None)),
                          src_data_rank=None)
    w1 = distribute_tensor(torch.randn(d, f, device="meta"), mesh,
                           placements(mesh, (None, "model")),
                           src_data_rank=None)
    w2 = distribute_tensor(torch.randn(f, d, device="meta"), mesh,
                           placements(mesh, ("model", None)),
                           src_data_rank=None)
    counter = dryrun.LocalCounter()
    with counter:
        rules.act((x @ w1) @ w2, "act")
    axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    out["tp_pair"] = {"shape": [b // 2, s, d], "collectives": [
        [name.split(".")[1], n, axes.get(g, g)]
        for name, n, g in counter.collectives]}
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    result = {"fake": _fake, "cells": _cells}[sys.argv[1]]()
    print(json.dumps(result), flush=True)
