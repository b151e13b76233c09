"""End-to-end training on the PyTorch port: examples/train_100m.py's
configs, data, optimizer, checkpoint/restart, gradient compression and
printed lines through ``repro_torch``, the model on the card.  Training
attends through ``sdpa`` (the CUDA attention kernels serve only).

Default: a reduced model, 40 steps (the JAX example's CPU demo).
Full:  --full trains the real ~100M config (sized for one card).

The weights are drawn from seed 0.  Checkpoints are the JAX package's
layout, so ``--ckpt /tmp/repro_train_100m`` resumes from the JAX
example's run (bf16 leaves included) and the JAX example resumes from
this one's.

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--full] \
          [--steps N] [--device cpu]
"""

import argparse
import dataclasses

from repro_torch.configs import ARCHS
from repro_torch.data import (DataConfig, Prefetcher, SyntheticCorpus,
                              pack_documents)
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, TrainConfig, Trainer


def config(full: bool):
    """The model's config and the batch (sequences, tokens each)."""
    base = ARCHS["qwen3-0.6b"]
    if full:
        # ~100M-param family member: 12 layers, d=768, vocab 32k
        cfg = dataclasses.replace(
            base, name="qwen3-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32768,
            dtype="float32", remat=False)
        return cfg, 8, 512
    return base.reduced(), 8, 64


def trainer(model, steps: int, ckpt: str) -> Trainer:
    """Two microbatches, compressed gradients, a checkpoint every quarter
    of the run, AdamW with 10 warm-up steps."""
    return Trainer(model, TrainConfig(
        steps=steps, n_micro=2, compress_grads=True, ckpt_dir=ckpt,
        ckpt_every=max(steps // 4, 1),
        optimizer=AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)))


def batches(cfg, steps: int, batch: int, seq: int) -> Prefetcher:
    """Synthetic packed documents, seed 0, prefetched on a host thread."""
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    return Prefetcher(pack_documents(SyntheticCorpus(dcfg), steps + 8))


def main(argv=None) -> Trainer:
    """Trains and prints; returns the trainer (its history holds this
    run's steps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="~100M params instead of the smoke model")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_train_100m")
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg, batch, seq = config(args.full)
    print(f"training {cfg.name}: ~{cfg.param_count():.2e} params")
    model = build_model(cfg, args.device, seed=0)
    tr = trainer(model, args.steps, args.ckpt)
    if tr.maybe_restore():
        print(f"resumed from checkpoint at step {tr.step}")
    hist = tr.run(batches(cfg, args.steps, batch, seq))
    if hist:
        print(f"step {hist[0]['step']}: loss {hist[0]['loss']:.3f}  ->  "
              f"step {hist[-1]['step']}: loss {hist[-1]['loss']:.3f}")
        print(f"mean step time {sum(h['sec'] for h in hist) / len(hist):.3f}s,"
              f" checkpoints in {args.ckpt}")
    return tr


if __name__ == "__main__":
    main()
