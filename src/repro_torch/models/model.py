"""Model facade: build_model(cfg, device, seed) -> Model with forward /
loss (training) and init_cache / prefill / decode_step (serving), for every
family of the registry: dense, MoE and VLM (``Decoder``), the zamba2 hybrid
(``Hybrid``), the seamless encoder-decoder (``EncDec``) and xLSTM
(``XLSTM``); and for the port's layer-pattern stack (``NemotronH``).
Serving records no gradient: ``prefill`` and ``decode_step`` run under
``torch.no_grad()``, whatever the parameters' ``requires_grad``.

The JAX package's ``Model`` serves one sequence per call and the engine
vmaps it over slots.  Here the batch dimension is written out: the cache
keeps a position per row, ``pos (B,)``, and an absolute position per slot
and row, ``kpos (B, kv_len)``, so every row of one call carries its own ring
state (and, for MoE, its own expert groups); ``CACHE_BATCH_AXIS`` names the
batch axis of every cache entry.  The model holds its weights (``decoder``,
one of the stacks), and every entry point runs on ``device``.

Every entry point takes a Sharder (``shard``): under
``parallel.sharding.MeshRules`` (after ``distribute_model``) its plain
inputs are distributed by the rules' batch and cache specs, the stacks run
on DTensors, and the loss reduces the vocab-sharded logits in place.  On
the ``meta`` device (``build_model(cfg, device="meta")``, no weights drawn)
the entry points run on shapes alone, as the dry-run does;
``input_specs(shape)`` gives the meta stand-ins of a shape cell's inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.ssm import MLSTM_STATE, SLSTM_STATE
from repro_torch.models.transformer import (
    XLSTM,
    Decoder,
    EncDec,
    Hybrid,
    NemotronH,
    seeded_init,
)
from repro_torch.parallel.sharding import NOSHARD, axis_size, fit

# the batch (slot) axis of each tensor of a cache
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kpos": 0, "pos": 0, "ssm": 2,
                    "ssm_tail": 1, "enc_out": 0, "ssm_state": 1,
                    "conv_state": 1,
                    **dict.fromkeys(MLSTM_STATE + SLSTM_STATE, 1)}

# what a fresh cache holds, where it is not zero: no position yet in the
# ring, the xLSTM stabilisers at -1e30
CACHE_FILL = {"kpos": -1, "mlstm_m": -1e30, "slstm_m": -1e30}


def reset_cache(cache: dict) -> None:
    """Refill every tensor of ``cache`` in place with what a fresh cache
    holds (``Model.init_cache``): no tensor is rebound or moved."""
    for key, value in cache.items():
        if isinstance(value, torch.Tensor):
            value.fill_(CACHE_FILL.get(key, 0))


def is_xlstm(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" and cfg.xlstm


def net_type(cfg: ModelConfig) -> type[nn.Module]:
    """The stack that serves ``cfg``'s family."""
    if cfg.family == "hybrid":
        return Hybrid
    if cfg.family == "nemotron_h":
        return NemotronH
    if cfg.family == "encdec":
        return EncDec
    if is_xlstm(cfg):
        return XLSTM
    return Decoder


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  shard) -> torch.Tensor:
    """``Model.loss``'s cross-entropy on vocab-sharded DTensor logits
    (B, S, V): each rank's max and the label's logit from its vocab slice
    (``shard.local``), one all-reduce max, one all-reduce sum of the
    exponentials and one of the label logits over 'model' -- V is never
    gathered."""
    mesh = shard.mesh
    b, s, v = logits.shape
    spec = fit(mesh, (b, s, v), (shard.batch_axes, None, "model"))
    names = mesh.mesh_dim_names
    batch = spec[0] or ()
    batch = (batch,) if isinstance(batch, str) else batch

    def rows_pl(reduce):
        return tuple(Shard(0) if n in batch else
                     Partial(reduce) if n == "model" and spec[2]
                     else Replicate() for n in names)

    v_l = v // axis_size(mesh, spec[2])
    off = shard.axis_index("model") * v_l if spec[2] else 0
    lspec = spec[:2]
    top = shard.local(lambda lg: lg.detach().float().amax(dim=-1),
                      (logits,), (spec,), (rows_pl("max"),))
    top = top.redistribute(mesh, shard.spec_placements((b, s), lspec))

    def partials(lg, top, labels):
        lf = lg.float()
        total = torch.exp(lf - top[..., None]).sum(dim=-1)
        inside = (labels >= off) & (labels < off + v_l)
        idx = torch.clamp(labels.long() - off, 0, v_l - 1)
        mine = lf.gather(-1, idx[..., None])[..., 0]
        return total, torch.where(inside, mine, 0.0)

    total, tgt = shard.local(partials, (logits, top, labels),
                             (spec, lspec, lspec),
                             (rows_pl("sum"), rows_pl("sum")))
    lse = top + torch.log(total)
    valid = labels >= 0
    n = valid.sum().clamp(min=1)
    return torch.where(valid, lse - tgt, 0.0).sum() / n


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; asking for CUDA without a card is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


@dataclass
class Model:
    cfg: ModelConfig
    decoder: Decoder | Hybrid | EncDec | XLSTM | NemotronH
    device: torch.device

    # ------------------------------------------------------------------
    # forward / loss
    # ------------------------------------------------------------------

    def input_tensor(self, x, shard=NOSHARD) -> torch.Tensor:
        """A batch entry (numpy array or tensor) on this model's device;
        under a mesh, distributed by the rules' batch spec (a DTensor is
        left as it is)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        if shard.sharded:
            if isinstance(x, DTensor):
                return x
            x = x.to(self.device)
            return shard.distribute(x, shard.batch_specs(x))
        return x.to(self.device)

    def place_cache(self, cache: dict, shard) -> dict:
        """A cache of plain tensors as DTensors by the rules' cache specs
        (each rank keeps its slice; the caller goes on with the returned
        cache)."""
        if not shard.sharded:
            return cache
        return shard.distribute(cache, shard.cache_specs(cache))

    def forward(self, batch: dict, shard=NOSHARD
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits for training: batch {"tokens": (B, S) int,
        "labels", and "frontend" (B, F, d): an encoder-decoder's frame
        embeddings, or the patch embeddings put in front of a decoder's
        tokens, whose logits are then cut off}.  Returns (logits (B, S, V)
        in the model dtype, aux_loss f32 scalar)."""
        cfg = self.cfg
        net = self.decoder
        tokens = self.input_tensor(batch["tokens"], shard)
        if cfg.family == "encdec":
            enc_out = net.encode(self.input_tensor(batch["frontend"], shard),
                                 shard)
            logits, aux, _ = net(tokens, enc_out, shard=shard)
        elif cfg.family in ("hybrid", "ssm", "nemotron_h"):
            logits, aux, _ = net(tokens, shard=shard)
        else:
            prefix = batch.get("frontend")
            if prefix is not None:
                prefix = self.input_tensor(prefix, shard)
            logits, aux, _ = net(tokens, prefix_embeds=prefix, shard=shard)
            if prefix is not None:
                logits = logits[:, prefix.shape[1]:]
        if not isinstance(aux, torch.Tensor):
            aux = torch.as_tensor(aux, dtype=torch.float32,
                                  device=self.device)
        return logits, aux

    def loss(self, batch: dict, shard=NOSHARD) -> torch.Tensor:
        """Mean next-token cross-entropy over the f32 logits, labels < 0
        masked out and the sum divided by max(#valid, 1), plus the aux
        loss: the JAX package's ``Model.loss``."""
        with shard.context():
            logits, aux = self.forward(batch, shard)
            labels = self.input_tensor(batch["labels"], shard).long()
            if shard.sharded:
                return cross_entropy(logits, labels, shard) + aux
            logp = torch.log_softmax(logits.float(), dim=-1)
            valid = labels >= 0
            safe = torch.where(valid, labels, 0)
            tok_lp = logp.gather(-1, safe[..., None])[..., 0]
            n = valid.sum().clamp(min=1)
            ce = -torch.where(valid, tok_lp, 0.0).sum() / n
            return ce + aux

    # ------------------------------------------------------------------
    # serving: cache + prefill + decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int, page_size: int = 16,
                   src_len: int = 0) -> dict:
        """A fresh cache.  ``page_size`` is the page size the decode
        kernel views the KV cache in (full attention only).  A hybrid
        keeps the shared block's KV per application, sized by ``max_seq``
        as the reference sizes it, and every Mamba2 layer's state in f32.
        An encoder-decoder adds ``enc_out`` (batch, src_len, d), which
        ``prefill`` replaces with the encoder's output.  xLSTM keeps each
        pair's recurrent states in f32 (``MLSTM_STATE``, ``SLSTM_STATE``:
        pair axis first, batch second; the stabilisers at -1e30) and a
        position per row.  A layer-pattern stack keeps KV per attention
        layer, each Mamba2 layer's state in f32 (``ssm_state``) and its
        conv's last inputs in the model dtype (``conv_state``)."""
        return self._cache(batch, max_seq, page_size, src_len, self.device)

    def _cache(self, batch: int, max_seq: int, page_size: int, src_len: int,
               dev: torch.device) -> dict:
        cfg = self.cfg
        pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if is_xlstm(cfg):
            f32 = dict(dtype=torch.float32, device=dev)
            lead = (cfg.n_layers // 2, batch)
            h, d = cfg.n_heads, cfg.d_model
            dh = d // h
            shapes = dict(zip(MLSTM_STATE + SLSTM_STATE,
                              [(h, dh, dh), (h, dh), (h,)] + [(d,)] * 4))
            cache = {name: torch.full(lead + shape, CACHE_FILL.get(name, 0),
                                      **f32)
                     for name, shape in shapes.items()}
            return {**cache, "pos": pos}
        if cfg.family == "hybrid":
            n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
            n_kv, kv_len = n_super, max_seq
        elif cfg.layer_pattern:
            n_kv, kv_len = cfg.layer_pattern.count("*"), max_seq
        else:
            n_kv = cfg.n_layers
            kv_len = max_seq if cfg.swa_window == 0 else min(max_seq,
                                                             cfg.swa_window)
        shape = (n_kv, batch, kv_len, cfg.n_kv_heads, cfg.hd)
        cache = {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "kpos": torch.full((batch, kv_len), CACHE_FILL["kpos"],
                               dtype=torch.int32, device=dev),
            "pos": pos,
            "page_size": page_size,
        }
        if cfg.family == "hybrid":
            state = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            cache["ssm"] = torch.zeros((n_super, cfg.attn_every) + state,
                                       dtype=torch.float32, device=dev)
            if n_tail:
                cache["ssm_tail"] = torch.zeros((n_tail,) + state,
                                                dtype=torch.float32,
                                                device=dev)
        if cfg.layer_pattern:
            n_m = cfg.layer_pattern.count("M")
            cache["ssm_state"] = torch.zeros(
                (n_m, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                dtype=torch.float32, device=dev)
            cache["conv_state"] = torch.zeros(
                (n_m, batch, cfg.conv_kernel - 1, cfg.d_inner
                 + 2 * cfg.ssm_groups * cfg.ssm_state),
                dtype=dtype_of(cfg), device=dev)
        if cfg.family == "encdec":
            cache["enc_out"] = torch.zeros((batch, src_len, cfg.d_model),
                                           dtype=dtype_of(cfg), device=dev)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict,
                frontend: torch.Tensor | None = None, shard=NOSHARD,
                fresh: bool | None = None) -> tuple[torch.Tensor, dict]:
        """Process the prompt, fill the cache, return last-position logits
        (B, 1, V).  ``fresh`` says whether every row is at position 0: a
        fresh cache takes the flash kernel.  None reads it back from the
        cache (one small device-to-host copy); a caller that made the cache
        fresh says so, and the prefill then never waits for the device.  A
        hybrid's Mamba2 layers scan the prompt through the SSD kernel.
        ``frontend`` (B, F, d): an encoder-decoder's frame embeddings, which
        the encoder reads and whose output the cache keeps as ``enc_out``;
        a VLM's patch embeddings, put in front of the tokens.  A cache on
        the meta device holds no positions and counts as fresh (the
        dry-run's prefill cells start from an empty cache)."""
        cfg = self.cfg
        with shard.context():
            tokens = self.input_tensor(tokens, shard)
            if frontend is not None:
                frontend = self.input_tensor(frontend, shard)
            cache = self.place_cache(cache, shard)
            if fresh is None:
                fresh = _fresh(cache["pos"])
            if cfg.family == "encdec":
                if frontend is None:
                    raise ValueError(f"{cfg.name}: an encoder-decoder "
                                     "prefill needs the frontend's frame "
                                     "embeddings")
                enc_out = self.decoder.encode(frontend, shard)
                logits, _, new_cache = self.decoder(
                    tokens, enc_out, cache=cache, last_only=True,
                    fresh=fresh, shard=shard)
                new_cache["enc_out"] = enc_out
            elif cfg.family == "vlm":
                logits, _, new_cache = self.decoder(
                    tokens, cache=cache, last_only=True, fresh=fresh,
                    prefix_embeds=frontend, shard=shard)
            else:
                logits, _, new_cache = self.decoder(
                    tokens, cache=cache, last_only=True, fresh=fresh,
                    shard=shard)
            return logits[:, -1:], new_cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, shard=NOSHARD
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache.
        An encoder-decoder cache without ``enc_out`` is prefilled, as the
        JAX package's ``Model.decode_step`` does."""
        if self.cfg.family == "encdec" and "enc_out" not in cache:
            return self.prefill(tokens, cache, shard=shard)
        with shard.context():
            tokens = self.input_tensor(tokens, shard)
            cache = self.place_cache(cache, shard)
            if self.cfg.family != "encdec":
                logits, _, new_cache = self.decoder(tokens, cache=cache,
                                                    shard=shard)
                return logits, new_cache
            logits, _, new_cache = self.decoder(tokens, cache["enc_out"],
                                                cache=cache, shard=shard)
            new_cache["enc_out"] = cache["enc_out"]
            return logits, new_cache

    # ------------------------------------------------------------------
    # dry-run input specs
    # ------------------------------------------------------------------

    def input_specs(self, shape: "ShapeSpec") -> dict:
        """Meta-tensor stand-ins for every model input of a shape cell, with
        the JAX package's keys and shapes: {"batch": {"tokens", "labels"[,
        "frontend"]}} to train; {"tokens", "cache"[, "frontend"]} to
        prefill; {"tokens" (B, 1), "cache"} to decode.  The cache is the
        port's: per-row ``pos`` (B,) and ``kpos`` (B, kv_len) where the
        reference keeps one of each, and the ``page_size`` the decode
        kernel views it in."""
        cfg = self.cfg
        meta = torch.device("meta")
        i32 = dict(dtype=torch.int32, device=meta)
        dt = dict(dtype=dtype_of(cfg), device=meta)
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            batch = {"tokens": torch.empty((B, S), **i32),
                     "labels": torch.empty((B, S), **i32)}
            if cfg.family == "vlm":
                ftok = cfg.frontend_tokens
                batch = {"tokens": torch.empty((B, S - ftok), **i32),
                         "labels": torch.empty((B, S - ftok), **i32),
                         "frontend": torch.empty((B, ftok, cfg.d_model),
                                                 **dt)}
            elif cfg.family == "encdec":
                batch["frontend"] = torch.empty((B, S, cfg.d_model), **dt)
            return {"batch": batch}
        if shape.kind == "prefill":
            spec = {"tokens": torch.empty((B, S), **i32),
                    "cache": self._cache(B, S, 16, S, meta)}
            if cfg.family == "encdec":
                spec["frontend"] = torch.empty((B, S, cfg.d_model), **dt)
            if cfg.family == "vlm":
                ftok = cfg.frontend_tokens
                spec["tokens"] = torch.empty((B, S - ftok), **i32)
                spec["frontend"] = torch.empty((B, ftok, cfg.d_model), **dt)
            return spec
        # decode: one new token against a seq_len-deep cache
        return {"tokens": torch.empty((B, 1), **i32),
                "cache": self._cache(B, S, 16, min(S, 4096), meta)}


def _fresh(pos: torch.Tensor) -> bool:
    """Whether every row of a cache is at position 0 (one small read back;
    a meta cache counts as fresh)."""
    if pos.device.type == "meta":
        return True
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    return not bool(pos.any())


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> Model:
    """A model with seeded random weights on ``device``; on ``meta`` the
    modules alone, no weight drawn (shapes for the dry-run)."""
    dev = resolve_device(device)
    net = net_type(cfg)(cfg, dev)
    if dev.type != "meta":
        net = seeded_init(net, torch.Generator().manual_seed(seed))
    return Model(cfg, net, dev)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
