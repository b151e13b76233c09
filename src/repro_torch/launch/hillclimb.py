"""Perf hill-climbing runs of the three selected cells.

Each variant is a (cell, rules) pair run through the dry-run and the
roofline (``roofline.analyze_cell``: host counts over meta tensors, priced
at H100 rates); results land in artifacts/hillclimb/ with the exact
before/after numbers.

Cells (worst roofline fraction / most collective-bound / most
representative of the paper's subject):
  A. qwen2-moe-a2.7b  train_4k   -- worst fraction (MoE dispatch path)
  B. mistral-large-123b decode_32k -- most collective-bound (ZeRO-inference
     weight gathers); decode is the paper's core subject
  C. llama3.2-3b prefill_32k     -- collective-bound dense serving cell
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.mesh import make_production_mesh, start_group
from repro_torch.launch.roofline import analyze_cell

VARIANTS: dict[str, list[tuple[str, str, dict]]] = {
    "A_moe_train": [
        ("qwen2-moe-a2.7b", "train_4k", {}),                       # iter1
        ("qwen2-moe-a2.7b", "train_4k", {"seq_parallel": True}),   # iter3
    ],
    "B_mistral_decode": [
        ("mistral-large-123b", "decode_32k", {}),                  # baseline
        ("mistral-large-123b", "decode_32k",
         {"decode_2d": True, "fsdp": False}),                      # iter1
    ],
    "C_llama_prefill": [
        ("llama3.2-3b", "prefill_32k", {}),                        # iter1
        ("llama3.2-3b", "prefill_32k", {"seq_parallel": True}),    # iter2
    ],
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--group", default=None,
                    help="A_moe_train | B_mistral_decode | C_llama_prefill")
    ap.add_argument("--out", default="artifacts/hillclimb")
    ap.add_argument("--base-only", action="store_true",
                    help="only each group's first variant")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    start_group(fake_world=256)
    mesh = make_production_mesh(multi_pod=False)
    for group, variants in VARIANTS.items():
        if args.group and group != args.group:
            continue
        for i, (arch, shape, rules) in enumerate(variants):
            if args.base_only and i:
                continue
            tag = "_".join(f"{k}" for k in rules) or "base"
            path = os.path.join(args.out, f"{group}__{i}_{tag}.json")
            if os.path.exists(path):
                print(f"[cached] {group} #{i} {tag}")
                continue
            print(f"[hillclimb] {group} #{i} {arch} {shape} rules={rules}",
                  flush=True)
            try:
                rec = analyze_cell(arch, shape, mesh, **rules)
                r = rec["roofline"]
                print(f"  compute={r['compute_s'] * 1e3:.1f}ms "
                      f"memory={r['memory_s'] * 1e3:.1f}ms "
                      f"coll={r['collective_s'] * 1e3:.1f}ms "
                      f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                import traceback
                rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"  FAIL {rec['error']}", flush=True)
            rec["variant"] = {"group": group, "iter": i, "rules": rules}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
