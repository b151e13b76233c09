"""Model facade for serving: build_model(cfg, device, seed) -> Model with
init_cache / prefill / decode_step.

The JAX package's ``Model`` serves one sequence per call and the engine
vmaps it over slots.  Here the batch dimension is written out: the cache
keeps a position per row, ``pos (B,)``, and an absolute position per slot
and row, ``kpos (B, kv_len)``, so every row of one call carries its own ring
state.  The model holds its weights (``decoder``), and every entry point
runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import Decoder, decoder_init


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
    decoder: Decoder
    device: torch.device

    def init_cache(self, batch: int, max_seq: int,
                   page_size: int = 16) -> dict:
        """A fresh KV cache.  ``page_size`` is the page size the decode
        kernel views the cache in (full attention only)."""
        cfg = self.cfg
        kv_len = max_seq if cfg.swa_window == 0 else min(max_seq,
                                                         cfg.swa_window)
        shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads, cfg.hd)
        dev = self.device
        return {
            "k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "kpos": torch.full((batch, kv_len), -1, dtype=torch.int32,
                               device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "page_size": page_size,
        }

    def prefill(self, tokens: torch.Tensor, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """Process the prompt, fill the cache, return last-position logits
        (B, 1, V).  Reads back whether every row is at position 0 (one small
        device-to-host copy): a fresh cache takes the flash kernel."""
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
    return Model(cfg, decoder_init(cfg, dev, gen), dev)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
