"""Model facade for serving: build_model(cfg, device, seed) -> Model with
init_cache / prefill / decode_step, for the dense and hybrid families.

The JAX package's ``Model`` serves one sequence per call and the engine
vmaps it over slots.  Here the batch dimension is written out: the cache
keeps a position per row, ``pos (B,)``, and an absolute position per slot
and row, ``kpos (B, kv_len)``, so every row of one call carries its own ring
state; ``CACHE_BATCH_AXIS`` names the batch axis of every cache entry.  The
model holds its weights (``decoder``: a ``Decoder`` or a ``Hybrid``), and
every entry point runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (
    Decoder,
    Hybrid,
    decoder_init,
    hybrid_init,
)

# the batch (slot) axis of each tensor of a cache
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kpos": 0, "pos": 0, "ssm": 2,
                    "ssm_tail": 1}


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
    decoder: Decoder | Hybrid
    device: torch.device

    def init_cache(self, batch: int, max_seq: int,
                   page_size: int = 16) -> dict:
        """A fresh cache.  ``page_size`` is the page size the decode
        kernel views the KV cache in (full attention only).  A hybrid
        keeps the shared block's KV per application, sized by ``max_seq``
        as the reference sizes it, and every Mamba2 layer's state in f32."""
        cfg = self.cfg
        dev = self.device
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
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
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
        return cache

    def prefill(self, tokens: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """Process the prompt, fill the cache, return last-position logits
        (B, 1, V).  Reads back whether every row is at position 0 (one small
        device-to-host copy): a fresh cache takes the flash kernel.  A
        hybrid's Mamba2 layers scan the prompt through the SSD kernel."""
        fresh = not bool(cache["pos"].any())
        logits, new_cache = self.decoder(tokens, cache=cache,
                                         last_only=True, fresh=fresh)
        return logits[:, -1:], new_cache

    def decode_step(self, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1) -> logits (B, 1, V), new cache."""
        return self.decoder(tokens, cache=cache)


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> Model:
    """A model with seeded random weights on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init = hybrid_init if cfg.family == "hybrid" else decoder_init
    return Model(cfg, init(cfg, dev, gen), dev)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
