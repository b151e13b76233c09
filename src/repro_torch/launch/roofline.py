"""Roofline analysis of the dry-run's records on an H100 cluster.

The JAX package lowers each cell again at small unrolled depths because
XLA's cost analysis counts a scan body once; it fits

    flops(L) = out + L * per_layer            (dense/moe/vlm: 2 lowerings)
    flops(e, d) = out + e*enc + d*dec         (encdec: 3 lowerings)
    flops(s, k) = out + s*shared + s*k*mamba  (hybrid: 3 lowerings)

and extrapolates to the production depth.  The port's eager count visits
every layer, so the production record is already whole: the same
calibration runs as a check (it must reproduce the production count), and
its solve and relative difference are recorded (``calibration_check``).

Hardware model (NVIDIA H100 SXM datasheet figures, per GPU):
  989 TFLOP/s dense bf16 tensor-core peak, 3.35 TB/s HBM3; NVLink 4 at
  450 GB/s a direction within a node of 8 GPUs, and a 400 Gb/s NIC
  (50 GB/s) per GPU between nodes.

    compute term    = flops_per_device / peak_flops
    memory term     = bytes_per_device / hbm_bw
    collective term = sum over mesh axes of that axis's collective bytes /
                      its link's rate (NVLink when each of the axis's
                      groups lies within one node of 8 ranks, else the NIC)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cells
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_production_mesh, start_group

PEAK_FLOPS = 989e12        # bf16 dense / GPU (H100 SXM datasheet)
HBM_BW = 3.35e12           # bytes/s / GPU (H100 SXM datasheet)
NVLINK_BW = 450e9          # bytes/s a direction / GPU (NVLink 4)
NIC_BW = 50e9              # bytes/s / GPU (400 Gb/s NIC)
NODE = 8                   # GPUs a node


def _with(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _lower_variant(arch_cfg, shape_name: str, mesh, **rules_kw) -> dict:
    """Lower a config variant and return its raw record."""
    name = arch_cfg.name
    ARCHS[name] = arch_cfg          # registry override (restored by caller)
    return lower_cell(name, shape_name, mesh, **rules_kw)


def calibration_plan(cfg):
    """Returns list of (tag, variant_cfg) lowerings + solver fn."""
    base = _with(cfg, unroll_layers=True, name=cfg.name)
    if cfg.family == "hybrid":
        v = [
            ("s1k1", _with(base, n_layers=1, attn_every=1)),
            ("s1k2", _with(base, n_layers=2, attn_every=2)),
            ("s2k1", _with(base, n_layers=2, attn_every=1)),
        ]

        def solve(f):
            mamba = f["s1k2"] - f["s1k1"]
            shared = f["s2k1"] - f["s1k1"] - mamba
            out = f["s1k1"] - shared - mamba
            n_super = cfg.n_layers // cfg.attn_every
            return out + n_super * shared + cfg.n_layers * mamba
        return v, solve
    if cfg.family == "encdec":
        v = [
            ("e1d1", _with(base, enc_layers=1, n_layers=1)),
            ("e2d1", _with(base, enc_layers=2, n_layers=1)),
            ("e1d2", _with(base, enc_layers=1, n_layers=2)),
        ]

        def solve(f):
            enc = f["e2d1"] - f["e1d1"]
            dec = f["e1d2"] - f["e1d1"]
            out = f["e1d1"] - enc - dec
            return out + cfg.enc_layers * enc + cfg.n_layers * dec
        return v, solve
    if cfg.family == "ssm" and cfg.xlstm:
        v = [
            ("p1", _with(base, n_layers=2)),    # 1 pair
            ("p2", _with(base, n_layers=4)),    # 2 pairs
        ]

        def solve(f):
            pair = f["p2"] - f["p1"]
            out = f["p1"] - pair
            return out + (cfg.n_layers // 2) * pair
        return v, solve
    # dense / moe / vlm
    v = [
        ("l1", _with(base, n_layers=1)),
        ("l2", _with(base, n_layers=2)),
    ]

    def solve(f):
        layer = f["l2"] - f["l1"]
        out = f["l1"] - layer
        return out + cfg.n_layers * layer
    return v, solve


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode D=batch."""
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * cfg.active_param_count() * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * cfg.active_param_count() * d
    return 2.0 * cfg.active_param_count() * shape.global_batch


def link_bw(mesh) -> dict[str, float]:
    """Each mesh axis's link rate: NVLink when every group of the axis lies
    within one node of ``NODE`` ranks, else the NIC; "other" (a group of
    several axes) at the NIC."""
    out = {"other": NIC_BW}
    for axis in mesh.mesh_dim_names:
        ranks = dist.get_process_group_ranks(mesh.get_group(axis))
        within = len({r // NODE for r in ranks}) == 1
        # every group of an axis has the same shape: one tells for all
        out[axis] = NVLINK_BW if within else NIC_BW
    return out


def analyze_cell(arch: str, shape_name: str, mesh, calibrate: bool = True,
                 prod_record: dict | None = None, **rules_kw) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    prod = prod_record or lower_cell(arch, shape_name, mesh, **rules_kw)
    n_dev = prod["n_devices"]

    flops = prod["flops_per_device"]
    calib, check = {}, {}
    if calibrate:
        variants, solve = calibration_plan(cfg)
        recs = {}
        orig = ARCHS[arch]
        try:
            for tag, vcfg in variants:
                recs[tag] = _lower_variant(vcfg, shape_name, mesh,
                                           **rules_kw)
        finally:
            ARCHS[arch] = orig
        for key in ("flops_per_device", "bytes_per_device"):
            got = solve({t: r[key] for t, r in recs.items()})
            check[key] = {"solve": got, "production": prod[key],
                          "rel_diff": (got - prod[key]) / prod[key]
                          if prod[key] else 0.0}
        calib = {t: {"flops": r["flops_per_device"],
                     "compile_s": r["compile_s"], "lower_s": r["lower_s"]}
                 for t, r in recs.items()}

    bw = link_bw(mesh)
    by_axis = prod.get("collective_bytes_by_axis", {})
    compute_t = flops / PEAK_FLOPS
    memory_t = prod["bytes_per_device"] / HBM_BW
    coll_t = sum(b / bw.get(a, NIC_BW) for a, b in by_axis.items())
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    bound_s = max(terms.values())
    useful_frac = (mf / n_dev) / PEAK_FLOPS / bound_s if bound_s else 0.0

    return {
        **prod,
        "corrected": {
            "flops_per_device": flops,
            "bytes_per_device": prod["bytes_per_device"],
            "collective_bytes": dict(prod["collective_bytes"]),
        },
        "roofline": {
            **terms,
            "dominant": dominant,
            "model_flops_total": mf,
            "useful_flops_ratio": mf / (flops * n_dev) if flops else 0.0,
            "roofline_fraction": useful_frac,
            "link_bw": {a: bw.get(a, NIC_BW) for a in by_axis},
        },
        "calibration": calib,
        "calibration_check": check,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/roofline")
    ap.add_argument("--prod-dir", default="artifacts/dryrun",
                    help="reuse production records from the dry-run sweep")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    start_group(fake_world=256)
    mesh = make_production_mesh(multi_pod=False)
    todo = ([(a, s) for a, s, st in cells() if st == "run"] if args.all
            else [(args.arch, args.shape)])
    for arch, shape in todo:
        out_path = os.path.join(args.out, f"{arch}__{shape}.json")
        if os.path.exists(out_path):
            print(f"[skip-cached] {arch} {shape}")
            continue
        prod = None
        prod_path = os.path.join(args.prod_dir,
                                 f"{arch}__{shape}__single.json")
        if os.path.exists(prod_path):
            with open(prod_path) as f:
                cand = json.load(f)
            if cand.get("ok"):
                prod = cand
        print(f"[roofline] {arch} {shape} ...", flush=True)
        try:
            rec = analyze_cell(arch, shape, mesh, prod_record=prod)
            r = rec["roofline"]
            print(f"  compute={r['compute_s']*1e3:.2f}ms "
                  f"memory={r['memory_s']*1e3:.2f}ms "
                  f"coll={r['collective_s']*1e3:.2f}ms "
                  f"dominant={r['dominant']} "
                  f"roofline_frac={r['roofline_fraction']:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001
            import traceback
            rec = {"arch": arch, "shape": shape, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"  FAIL {rec['error']}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
