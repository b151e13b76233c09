"""Model facade: build_model(cfg, device, seed) -> Model with forward /
loss (training) and init_cache / prefill / decode_step (serving), for every
family of the registry: dense, MoE and VLM (``Decoder``), the zamba2 hybrid
(``Hybrid``), the seamless encoder-decoder (``EncDec``) and xLSTM
(``XLSTM``).  Serving records no gradient: ``prefill`` and ``decode_step``
run under ``torch.no_grad()``, whatever the parameters' ``requires_grad``.

The JAX package's ``Model`` serves one sequence per call and the engine
vmaps it over slots.  Here the batch dimension is written out: the cache
keeps a position per row, ``pos (B,)``, and an absolute position per slot
and row, ``kpos (B, kv_len)``, so every row of one call carries its own ring
state (and, for MoE, its own expert groups); ``CACHE_BATCH_AXIS`` names the
batch axis of every cache entry.  The model holds its weights (``decoder``,
one of the stacks), and every entry point runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.ssm import MLSTM_STATE, SLSTM_STATE
from repro_torch.models.transformer import (
    XLSTM,
    Decoder,
    EncDec,
    Hybrid,
    seeded_init,
)

# the batch (slot) axis of each tensor of a cache
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kpos": 0, "pos": 0, "ssm": 2,
                    "ssm_tail": 1, "enc_out": 0,
                    **dict.fromkeys(MLSTM_STATE + SLSTM_STATE, 1)}


def is_xlstm(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" and cfg.xlstm


def net_type(cfg: ModelConfig) -> type[nn.Module]:
    """The stack that serves ``cfg``'s family."""
    if cfg.family == "hybrid":
        return Hybrid
    if cfg.family == "encdec":
        return EncDec
    if is_xlstm(cfg):
        return XLSTM
    return Decoder


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
    decoder: Decoder | Hybrid | EncDec | XLSTM
    device: torch.device

    # ------------------------------------------------------------------
    # forward / loss
    # ------------------------------------------------------------------

    def input_tensor(self, x) -> torch.Tensor:
        """A batch entry (numpy array or tensor) on this model's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence logits for training: batch {"tokens": (B, S) int,
        "labels", and "frontend" (B, F, d): an encoder-decoder's frame
        embeddings, or the patch embeddings put in front of a decoder's
        tokens, whose logits are then cut off}.  Returns (logits (B, S, V)
        in the model dtype, aux_loss f32 scalar)."""
        cfg = self.cfg
        net = self.decoder
        tokens = self.input_tensor(batch["tokens"])
        if cfg.family == "encdec":
            enc_out = net.encode(self.input_tensor(batch["frontend"]))
            logits, aux, _ = net(tokens, enc_out)
        elif cfg.family in ("hybrid", "ssm"):
            logits, aux, _ = net(tokens)
        else:
            prefix = batch.get("frontend")
            if prefix is not None:
                prefix = self.input_tensor(prefix)
            logits, aux, _ = net(tokens, prefix_embeds=prefix)
            if prefix is not None:
                logits = logits[:, prefix.shape[1]:]
        return logits, torch.as_tensor(aux, dtype=torch.float32,
                                       device=self.device)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over the f32 logits, labels < 0
        masked out and the sum divided by max(#valid, 1), plus the aux
        loss: the JAX package's ``Model.loss``."""
        logits, aux = self.forward(batch)
        labels = self.input_tensor(batch["labels"]).long()
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
        position per row."""
        cfg = self.cfg
        dev = self.device
        pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if is_xlstm(cfg):
            f32 = dict(dtype=torch.float32, device=dev)
            lead = (cfg.n_layers // 2, batch)
            h, d = cfg.n_heads, cfg.d_model
            dh = d // h
            shapes = dict(zip(MLSTM_STATE + SLSTM_STATE,
                              [(h, dh, dh), (h, dh), (h,)] + [(d,)] * 4))
            cache = {name: torch.zeros(lead + shape, **f32)
                     for name, shape in shapes.items()}
            cache["mlstm_m"].fill_(-1e30)
            cache["slstm_m"].fill_(-1e30)
            return {**cache, "pos": pos}
        if cfg.family == "hybrid":
            n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
            n_kv, kv_len = n_super, max_seq
        else:
            n_kv = cfg.n_layers
            kv_len = max_seq if cfg.swa_window == 0 else min(max_seq,
                                                             cfg.swa_window)
        shape = (n_kv, batch, kv_len, cfg.n_kv_heads, cfg.hd)
        cache = {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "kpos": torch.full((batch, kv_len), -1, dtype=torch.int32,
                               device=dev),
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
        if cfg.family == "encdec":
            cache["enc_out"] = torch.zeros((batch, src_len, cfg.d_model),
                                           dtype=dtype_of(cfg), device=dev)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict,
                frontend: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Process the prompt, fill the cache, return last-position logits
        (B, 1, V).  Reads back whether every row is at position 0 (one small
        device-to-host copy): a fresh cache takes the flash kernel.  A
        hybrid's Mamba2 layers scan the prompt through the SSD kernel.
        ``frontend`` (B, F, d): an encoder-decoder's frame embeddings, which
        the encoder reads and whose output the cache keeps as ``enc_out``;
        a VLM's patch embeddings, put in front of the tokens."""
        cfg = self.cfg
        fresh = not bool(cache["pos"].any())
        if cfg.family == "encdec":
            if frontend is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder prefill "
                                 "needs the frontend's frame embeddings")
            enc_out = self.decoder.encode(frontend)
            logits, _, new_cache = self.decoder(
                tokens, enc_out, cache=cache, last_only=True, fresh=fresh)
            new_cache["enc_out"] = enc_out
        elif cfg.family == "vlm":
            logits, _, new_cache = self.decoder(
                tokens, cache=cache, last_only=True, fresh=fresh,
                prefix_embeds=frontend)
        else:
            logits, _, new_cache = self.decoder(
                tokens, cache=cache, last_only=True, fresh=fresh)
        return logits[:, -1:], new_cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache.
        An encoder-decoder cache without ``enc_out`` is prefilled, as the
        JAX package's ``Model.decode_step`` does."""
        if self.cfg.family != "encdec":
            logits, _, new_cache = self.decoder(tokens, cache=cache)
            return logits, new_cache
        if "enc_out" not in cache:
            return self.prefill(tokens, cache)
        logits, _, new_cache = self.decoder(tokens, cache["enc_out"],
                                            cache=cache)
        new_cache["enc_out"] = cache["enc_out"]
        return logits, new_cache


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> Model:
    """A model with seeded random weights on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Model(cfg, seeded_init(net_type(cfg)(cfg, dev), gen), dev)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
