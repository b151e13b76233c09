"""Training launcher: ``--arch`` selects any registry architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 20 --batch 8 --seq 64 --ckpt /tmp/ck --device cpu

The reduced config by default (``--full-config`` for the published one);
seeded weights (``--seed``); the model trains on the card (``--device
cuda``, the default) or, with ``--device cpu``, on the kernels' plain
versions on the CPU.

A sharded run (``--mesh data,model``) builds ``MeshRules`` over a d x m
DeviceMesh of the process group and trains the DTensor-sharded model (the
Trainer's ``shard``): under ``torchrun`` with d * m ranks (NCCL on the
card, gloo with ``--device cpu``), or with ``--mesh 1,1`` alone, which
starts a group of one rank itself.  Rank 0 prints.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --arch qwen3-0.6b --mesh 2,2 --steps 4
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import ARCHS
from repro_torch.data import (DataConfig, Prefetcher, SyntheticCorpus,
                              pack_documents)
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, TrainConfig, Trainer
from repro_torch.training.train_loop import _rank


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full published config")
    ap.add_argument("--mesh", default="",
                    help="data,model extents for a sharded run, e.g. 2,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        world = int(os.environ.get("WORLD_SIZE", 1))
        if d * m != world:
            ap.error(f"--mesh {args.mesh} needs {d * m} ranks (torchrun "
                     f"--nproc-per-node {d * m}); this run has {world}")
    return args


def make_rules(args: argparse.Namespace):
    """``MeshRules`` over a (data, model) mesh of ``--mesh``'s extents, the
    process group started for ``--device``; None without ``--mesh``."""
    if not args.mesh:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import mesh_device_type, start_group
    from repro_torch.parallel.sharding import MeshRules
    d, m = (int(x) for x in args.mesh.split(","))
    start_group(args.device)
    mesh = init_device_mesh(mesh_device_type(), (d, m),
                            mesh_dim_names=("data", "model"))
    return MeshRules(mesh)


def setup(args: argparse.Namespace) -> tuple[Trainer, Prefetcher]:
    """The trainer and its data, as ``main`` runs them."""
    cfg = ARCHS[args.arch]
    if not args.full_config:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=args.seed)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    data = Prefetcher(pack_documents(SyntheticCorpus(dcfg),
                                     args.steps + 4))
    tcfg = TrainConfig(
        steps=args.steps, n_micro=args.micro,
        compress_grads=args.compress_grads, ckpt_dir=args.ckpt,
        ckpt_every=max(args.steps // 4, 1),
        optimizer=AdamWConfig(warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps))
    return Trainer(model, tcfg, shard=make_rules(args)), data


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    trainer, data = setup(args)
    cfg = trainer.model.cfg
    say = print if _rank() == 0 else (lambda *a, **k: None)
    mesh = f", mesh {args.mesh}" if args.mesh else ""
    say(f"[train] {cfg.name}: ~{cfg.param_count():.2e} params, "
        f"{args.steps} steps{mesh}")
    if trainer.maybe_restore():
        say(f"[train] resumed at step {trainer.step}")
    hist = trainer.run(data)
    for h in hist[:: max(len(hist) // 8, 1)]:
        say(f"  step {h['step']:4d} loss {h['loss']:.4f} "
            f"gnorm {h['grad_norm']:.2f} {h['sec'] * 1e3:.0f} ms")
    if hist:
        say(f"[train] done: loss {hist[0]['loss']:.3f} -> "
            f"{hist[-1]['loss']:.3f}")
    if args.mesh:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
