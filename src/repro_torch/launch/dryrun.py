"""Multi-pod dry-run: run every (arch x shape x mesh) cell once on the
production meshes with meta tensors (no allocation, no data), the model's
parameters and inputs DTensors on a ``fake`` process group of 256 (or 512)
ranks, and record per-device op counts, bytes, collective bytes and memory
for the roofline.  The counterpart of the JAX package's lower + compile.

Nothing runs on a card: these are host counts over meta tensors.  Each
record field means:
  flops_per_device   FLOPs of this rank's local ops (matmuls, convolutions,
                     attention products by ``torch.utils.flop_counter``'s
                     formulas) -- counted on the local shards, never at a
                     DTensor's global shape;
  bytes_per_device   the operands and results of each local op, summed:
                     what eager execution moves with no fusion; view ops
                     move nothing, and a hand-written kernel's call counts
                     its inputs and outputs once (``ops.meta_region``);
  collective_bytes   each functional collective's result bytes on this
                     rank, by kind (all-gather, reduce-scatter, all-reduce,
                     all-to-all, collective-permute);
  collective_bytes_by_axis  the same bytes by the mesh axis whose group ran
                     the collective ("data", "model", "pod"; "other" for a
                     group of several axes), which the roofline prices by
                     link;
  memory             argument_bytes / output_bytes: the step's inputs and
                     outputs as local shards (parameters, optimizer state,
                     batch or cache; updated parameters and state, or logits
                     and cache); temp_bytes: the peak of live intermediate
                     tensors made by local ops (saved activations included);
                     generated_code_bytes: 0 (nothing is compiled);
  lower_s            host seconds to build, distribute and run the step;
  compile_s          0 (eager: nothing is compiled).
The train step is loss, backward and AdamW; prefill and decode are
``Model.prefill`` / ``Model.decode_step`` once.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out artifacts/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, cells
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh, start_group
from repro_torch.models import build_model
from repro_torch.parallel.sharding import MeshRules, distribute_model
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}

# ops that move no data: views, aliases, metadata
_VIEWS = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "as_strided", "detach", "alias",
    "unsqueeze", "squeeze", "split", "split_with_sizes", "chunk", "unbind",
    "view_as", "_reshape_alias", "unflatten", "flatten", "narrow",
    "lift_fresh", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def collective_bytes(records) -> dict[str, float]:
    """Sum result bytes of (op name, result bytes, ...) records by
    collective kind; other ops are ignored."""
    out: dict[str, float] = {}
    for name, nbytes, *_ in records:
        base = name.split(".")[1] if "." in name else name
        kind = COLLECTIVES.get(base)
        if kind is not None:
            out[kind] = out.get(kind, 0.0) + float(nbytes)
    return out


class LocalCounter(TorchDispatchMode):
    """Counts the local ops a step runs on this rank.  An op on DTensors is
    handed to DTensor (``NotImplemented``), which runs its local ops and
    collectives back through this mode; DTensor's own shape propagation
    (on fake tensors) is skipped."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int, str]] = []
        self.live = 0
        self.peak = 0
        self._region = 0

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    @contextlib.contextmanager
    def kernel(self, name: str, inputs: tuple):
        """A hand-written kernel's call: its FLOPs from the plain version's
        ops, its bytes and memory from its inputs and outputs alone."""
        self._region += 1
        outs = []
        try:
            yield outs.append
        finally:
            self._region -= 1
        produced = _tensors(outs)
        self.bytes += sum(map(_nbytes, inputs)) + sum(map(_nbytes, produced))
        for t in produced:
            self._alloc(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(type(t).__name__ == "FakeTensor" for t in ins + outs):
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
            if name not in COLLECTIVES:      # wait_tensor and the like
                return out
            # the group's name is the op's last string argument
            group = [a for a in args if isinstance(a, str)][-1:] or [""]
            group = group[0]
            self.collectives.append(
                (f"{ns}.{name}", sum(map(_nbytes, outs)), group))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if self._region or name in _VIEWS:
            return out
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        returns = func._schema.returns
        for t, ret in zip(outs, returns):
            if ret.alias_info is None:
                self._alloc(t)
        return out


def bytes_by_axis(records, mesh) -> dict[str, float]:
    """Collective result bytes by the mesh axis of the group that ran each
    (its group name matched to the mesh's per-axis groups)."""
    names = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    out: dict[str, float] = {}
    for _, nbytes, group in records:
        axis = names.get(group, "other")
        out[axis] = out.get(axis, 0.0) + float(nbytes)
    return out


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


def _tokens(shape) -> int:
    return shape.global_batch * (shape.seq_len if shape.kind
                                 in ("train", "prefill") else 1)


def lower_cell(arch: str, shape_name: str, mesh, **rules_kw) -> dict:
    """Build on meta, distribute, run the cell's step once; returns the
    roofline record (the JAX package's keys)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    rules = MeshRules(mesh, **{"fsdp": True, **rules_kw})
    t0 = time.time()
    model = distribute_model(build_model(cfg, device="meta"), rules)
    specs = model.input_specs(shape)
    counter = LocalCounter()
    ops.meta_region = counter.kernel
    try:
        if shape.kind == "train":
            params = dict(model.decoder.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            opt = adamw_init(params)
            batch = {k: model.input_tensor(v, rules)
                     for k, v in specs["batch"].items()}
            args_bytes = _local_bytes((params, opt, batch))
            with counter, rules.context():
                loss = model.loss(batch, shard=rules)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                adamw_update(AdamWConfig(), grads, opt, params)
            out_bytes = _local_bytes((params, opt)) + 8
        else:
            tokens = model.input_tensor(specs["tokens"], rules)
            cache = model.place_cache(specs["cache"], rules)
            frontend = specs.get("frontend")
            if frontend is not None:
                frontend = model.input_tensor(frontend, rules)
            args_bytes = _local_bytes((dict(model.decoder.named_parameters()),
                                       tokens, cache, frontend))
            with counter:
                if shape.kind == "prefill":
                    logits, cache = model.prefill(tokens, cache, frontend,
                                                  shard=rules)
                else:
                    logits, cache = model.decode_step(tokens, cache,
                                                      shard=rules)
            out_bytes = _local_bytes((logits, cache))
    finally:
        ops.meta_region = None
    lower_s = time.time() - t0
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": int(mesh.size()),
        "ok": True,
        "lower_s": round(lower_s, 1),
        "compile_s": 0.0,
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes": collective_bytes(counter.collectives),
        "collective_bytes_by_axis": bytes_by_axis(counter.collectives, mesh),
        "memory": {
            "argument_bytes": int(args_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(counter.peak),
            "generated_code_bytes": 0,
        },
        "rules": rules_kw,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "tokens": _tokens(shape),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        for arch, shape, status in cells():
            print(f"{arch:24s} {shape:12s} {status}")
        return

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    start_group(fake_world=512 if True in meshes else 256)

    todo = []
    if args.all:
        todo = [(a, s) for a, s, st in cells() if st == "run"]
    else:
        todo = [(args.arch, args.shape)]

    n_fail = 0
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        tag = "multi" if multi else "single"
        for arch, shape in todo:
            out_path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
            if os.path.exists(out_path):
                print(f"[skip-cached] {arch} {shape} {tag}")
                continue
            print(f"[dryrun] {arch} {shape} mesh={tag} ...", flush=True)
            try:
                rec = lower_cell(arch, shape, mesh)
                coll = {k: f"{v:.2e}"
                        for k, v in rec["collective_bytes"].items()}
                print(f"  ok: lower={rec['lower_s']}s "
                      f"flops/dev={rec['flops_per_device']:.3e} "
                      f"coll={coll}", flush=True)
            except Exception as e:  # noqa: BLE001 -- record and continue
                rec = {"arch": arch, "shape": shape, "mesh": tag,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                n_fail += 1
                print(f"  FAIL: {rec['error']}", flush=True)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done; failures={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
