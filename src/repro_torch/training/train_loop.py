"""Trainer: the microbatched train step (activation checkpointing per
``cfg.remat``, optional compressed gradient accumulation), checkpoint/
restart, step-time telemetry with straggler accounting, and the mitigation
actuation surface: the JAX package's ``training/train_loop.py``.

The model holds its parameters; the Trainer makes them trainable
(``requires_grad``) and updates them in place.  Checkpoints hold the JAX
tree's leaves in its order (``bridge.to_jax_tree``): {"opt": {"error_buf"
(with compression), "m", "step", "v"}, "params"}, so either package's
Trainer resumes from the other's.

The same Trainer drives one device and a mesh: under a Sharder
(``shard``, ``parallel.sharding.MeshRules``) the parameters, the AdamW
moments and the error buffer are DTensors placed by the rules, each
microbatch is distributed over the batch axes, and a checkpoint holds the
full tensors (rank 0 writes it), so that a sharded run, an unsharded one
and the JAX package read each other's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.bridge import from_jax_tree, leaf_ranks, to_jax_tree
from repro_torch.core.events import Event, EventKind
from repro_torch.core.sketch import EWMA
from repro_torch.core.telemetry import TelemetryPlane
from repro_torch.models.model import Model
from repro_torch.parallel.collectives import accumulate_grads, init_error_buf
from repro_torch.parallel.sharding import NOSHARD, distribute_model, full
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)


@dataclass
class TrainConfig:
    steps: int = 50
    n_micro: int = 1
    compress_grads: bool = False
    ckpt_dir: str = ""
    ckpt_every: int = 25
    ckpt_keep: int = 3
    log_every: int = 10
    node: int = 0
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Trainer:
    def __init__(self, model: Model, tcfg: TrainConfig, shard=None,
                 plane: TelemetryPlane | None = None) -> None:
        self.model = model
        self.tcfg = tcfg
        self.plane = plane
        self.shard = shard or NOSHARD
        if self.shard.sharded:
            distribute_model(model, self.shard)
        self.params = dict(model.decoder.named_parameters())
        for p in self.params.values():
            p.requires_grad_(True)
        self.ranks = leaf_ranks(model.cfg, self.params)
        self.opt_state = adamw_init(self.params)
        if tcfg.compress_grads:
            self.opt_state["error_buf"] = init_error_buf(self.params)
        self.step = 0
        self.step_time = EWMA(0.1)
        self.history: list[dict] = []
        if self.plane is not None and self.plane.controller is not None:
            self.plane.controller.engine = self

    # ------------------------------------------------------------------

    def _loss(self, batch: dict) -> torch.Tensor:
        return self.model.loss(batch, shard=self.shard)

    def _train_step(self, micro_batches: dict):
        ebuf = self.opt_state.get("error_buf")
        with self.shard.context():
            loss, grads, new_ebuf = accumulate_grads(
                self._loss, self.params, micro_batches,
                compress=self.tcfg.compress_grads, error_buf=ebuf)
            metrics = adamw_update(self.tcfg.optimizer, grads,
                                   self.opt_state, self.params, self.ranks)
        if ebuf is not None:
            self.opt_state["error_buf"] = new_ebuf
        return full(loss), {k: full(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    # EngineControls (mitigation surface for training-side findings)
    # ------------------------------------------------------------------

    def apply_action(self, action: str, node: int, detail: dict) -> bool:
        if action in ("rebalance_microbatches", "rebalance_shards",
                      "repartition_stages", "batch_launches",
                      "isolate_host_threads", "pin_and_coalesce"):
            return True   # accounting hook; resharding is a restart-level op
        return False

    # ------------------------------------------------------------------

    def _emit(self, kind: EventKind, ts: float, **kw) -> None:
        if self.plane is not None:
            self.plane.observe(Event(ts=ts, kind=kind, node=self.tcfg.node,
                                     **kw))

    def _state_tree(self) -> dict:
        """The checkpoint's tree: the JAX package's {"params", "opt"}, of
        full tensors (a collective under a mesh: every rank calls it)."""
        cfg = self.model.cfg

        def tree(named):
            return to_jax_tree(cfg, {k: full(v) for k, v in named.items()})

        opt = {"m": tree(self.opt_state["m"]), "v": tree(self.opt_state["v"]),
               "step": full(self.opt_state["step"]).cpu().numpy()}
        if "error_buf" in self.opt_state:
            opt["error_buf"] = tree(self.opt_state["error_buf"])
        return {"params": tree(self.params), "opt": opt}

    @torch.no_grad()
    def _load_tree(self, tree: dict) -> None:
        cfg = self.model.cfg
        targets = [(self.params, tree["params"])]
        targets += [(self.opt_state[k], tree["opt"][k])
                    for k in ("m", "v", "error_buf") if k in self.opt_state]
        for named, sub in targets:
            for name, arr in from_jax_tree(cfg, sub).items():
                src = torch.from_numpy(np.array(arr, np.float32))
                dst = named[name]
                if self.shard.sharded:   # this rank's slice of the tensor
                    src = self.shard.distribute(
                        src.to(dst.dtype).to(dst.device_mesh.device_type),
                        self.shard.param_specs({name: dst})[name])
                dst.copy_(src)
        self.opt_state["step"].copy_(torch.as_tensor(
            np.asarray(tree["opt"]["step"])))

    def maybe_restore(self) -> bool:
        """Checkpoint/restart: resume from the latest checkpoint if any."""
        if not self.tcfg.ckpt_dir:
            return False
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        self._load_tree(ckpt.restore(self.tcfg.ckpt_dir, last,
                                     self._state_tree()))
        self.step = last
        return True

    def save(self) -> None:
        if self.tcfg.ckpt_dir:
            tree = self._state_tree()
            if _rank() == 0:
                ckpt.save(self.tcfg.ckpt_dir, self.step, tree,
                          keep=self.tcfg.ckpt_keep)
            if self.shard.sharded:
                torch.distributed.barrier()

    def run(self, batches, crash_at: int | None = None) -> list[dict]:
        """Train over an iterable of batches; ``crash_at`` injects a
        simulated failure after N steps (fault-tolerance tests)."""
        t0 = time.perf_counter()
        for batch in batches:
            if self.step >= self.tcfg.steps:
                break
            mb = self._microbatch(batch)
            ts = time.perf_counter() - t0
            self._emit(EventKind.H2D_XFER, ts, device=0,
                       size=sum(_nbytes(x) for x in batch.values()))
            self._emit(EventKind.DISPATCH, ts, device=0)
            st = time.perf_counter()
            loss, metrics = self._train_step(mb)
            loss = float(loss)
            dt = time.perf_counter() - st
            self.step_time.update(dt)
            ts = time.perf_counter() - t0
            self._emit(EventKind.D2H_XFER, ts, device=0, size=8)
            rec = {"step": self.step, "loss": loss, "sec": dt,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "straggler_z": self.step_time.zscore(dt)}
            self.history.append(rec)
            self.step += 1
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if crash_at is not None and self.step >= crash_at:
                raise RuntimeError("injected failure")
        self.save()
        return self.history

    def _microbatch(self, batch: dict) -> dict:
        """Each entry on the model's device, reshaped to (n_micro, B /
        n_micro, ...)."""
        n = self.tcfg.n_micro

        def split(x):
            x = self.model.input_tensor(x)
            return x.reshape(n, x.shape[0] // n, *x.shape[1:])
        return {k: split(v) for k, v in batch.items()}
