"""Model stacks: the decoder-only stack (dense llama / mistral / qwen: pre-
norm GQA attention plus SwiGLU MLP; MoE: the MLP replaced by shared plus
routed experts; VLM: the dense stack after the patch embeddings), the
zamba2 hybrid (a Mamba2 backbone with ONE parameter-shared attention+MLP
block applied after every ``attn_every`` layers), the seamless encoder-
decoder and the xLSTM stack, each with an optional cache; and the port's
own ``NemotronH``, a stack built from a layer pattern (no JAX
counterpart).

Counterparts of the JAX package's ``transformer.py``: ``seeded_init`` (the
``*_init`` functions' scheme), ``ring_info`` (the ring-buffer bookkeeping
of one step), ``DecoderLayer.forward`` (``_dense_layer_fwd``),
``Decoder.forward`` (``decoder_fwd``), ``Hybrid.forward`` (``hybrid_fwd``),
``EncDec.encode`` / ``EncDec.forward`` (``encode`` / ``encdec_fwd``) and
``XLSTM.forward`` (``xlstm_fwd``).  Layers are ``ModuleList``s walked by
Python loops in place of ``lax.scan``; the parameters of layer ``l`` are
slice ``l`` of the JAX package's layer-stacked leaves (``[i][j]`` for the
hybrid's super-blocks).  Every stack's ``forward`` returns ``(logits,
aux_loss, new_cache)`` as the reference's ``*_fwd`` do: the MoE layers'
summed aux and z losses (the float 0.0 for a stack without them).  Without
a cache, while a gradient is recorded and ``cfg.remat`` is set, each layer
(the hybrid's Mamba2 layers, each xLSTM pair) is recomputed in the backward
(``remat``, the reference's ``_maybe_remat``).

``Sharder`` is an optional activation-constraint hook (``shard``; see
``parallel.sharding``) so the same code runs unsharded (``NOSHARD``, the
plain ops) and fully sharded on DTensors (``MeshRules``): every stack calls
``shard.act`` where the reference does, with the same kind.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Attention,
    RMSNorm,
    cache_slice,
    dtype_of,
    ring_write,
    weight,
)
from repro_torch.models.moe import MoE, moe_fwd, moe_per_row
from repro_torch.models.ssm import MambaLayer, XLSTMPair
from repro_torch.parallel.sharding import NOSHARD, NoSharder


def ring_info(pos: torch.Tensor, s_total: int, max_seq: int,
              old_kpos: torch.Tensor, fresh: bool = False,
              page_size: int = 0, shard=NOSHARD
              ) -> tuple[dict, torch.Tensor]:
    """Ring-buffer bookkeeping shared by every attention layer of a step.

    pos: (B,) int32 next position per row; old_kpos: (B, max_seq) int32.
    ``page_size`` > 0 on a one-token step adds the cache viewed as pages of
    that size: an identity block table and the per-row lengths.  Under a
    mesh ``kpos`` is written slice by slice (``layers.ring_write``) and the
    pages are each rank's own (``layers.sharded_cache_attention``)."""
    q_pos = pos[:, None] + torch.arange(s_total, dtype=pos.dtype,
                                        device=pos.device)
    if shard.sharded:
        return _sharded_ring(pos, q_pos, max_seq, old_kpos, fresh,
                             page_size, shard)
    if s_total >= max_seq:
        return {"q_pos": q_pos, "fresh": fresh}, q_pos[:, -max_seq:]
    slots = (q_pos % max_seq).long()
    new_kpos = old_kpos.scatter(1, slots, q_pos)
    ring = {"slots": slots, "kpos": new_kpos, "q_pos": q_pos,
            "fresh": fresh}
    if page_size and s_total == 1:
        if max_seq % page_size:
            raise ValueError(f"kv_len {max_seq} is not a multiple of the "
                             f"page size {page_size}")
        b, per_seq = pos.shape[0], max_seq // page_size
        # row b's cache is pages b*per_seq .. b*per_seq + per_seq - 1;
        # after this write it holds min(pos + 1, kv_len) positions
        ring["table"] = torch.arange(b * per_seq, dtype=torch.int32,
                                     device=pos.device).view(b, per_seq)
        ring["lengths"] = torch.clamp(pos + 1, max=max_seq).to(torch.int32)
        ring["page_size"] = page_size
    return ring, new_kpos


def _sharded_ring(pos, q_pos, max_seq, old_kpos, fresh, page_size, shard):
    kspec, offset = cache_slice(shard, tuple(old_kpos.shape))
    new_kpos = shard.local(
        lambda buf, vals, pos: ring_write(buf, vals, pos, max_seq, offset),
        (old_kpos.clone(), q_pos, pos), (kspec, kspec[:1] + (None,),
                                         kspec[:1]), kspec)
    ring = {"kpos": new_kpos, "q_pos": q_pos, "fresh": fresh}
    if page_size and q_pos.shape[1] == 1:
        ring["page_size"] = page_size
    return ring, new_kpos


def remat(cfg: ModelConfig, layer: nn.Module, *args):
    """``layer(*args)``, its activations recomputed in the backward when
    ``cfg.remat`` asks for it and a gradient is being recorded."""
    if cfg.remat and torch.is_grad_enabled():
        shard = next((a for a in args if isinstance(a, NoSharder)), NOSHARD)
        if shard.sharded:   # the recomputation joins plain tensors too
            return checkpoint(layer, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  shard.context()))
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class DecoderLayer(nn.Module):
    """Pre-norm attention and SwiGLU MLP, or, for an MoE config, the
    ``MoE`` layer (``moe``) in place of the MLP.  ``ffn_in``: the MLP's input
    takes the reference's ``ffn_in`` constraint (its decoder layers do, the
    hybrid's shared block does not)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 ffn_in: bool = True) -> None:
        super().__init__()
        self.cfg = cfg
        self.ffn_in = ffn_in
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        if cfg.is_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache: dict | None = None, shard=NOSHARD,
                counts: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | float]:
        """Returns (x, aux): the MoE layer's aux and z losses (f32 scalar),
        or 0.0.  With a cache every row forms its own MoE groups, as the
        JAX package's engine decodes (one sequence per call, mapped over
        the slots); without one the rows' tokens are grouped together, as
        its ``decoder_fwd`` does.  ``counts``: ``moe.moe_fwd``'s."""
        x = x + shard.act(self.attn(self.ln1(x), positions, kv_cache,
                                    shard=shard), "act")
        h = self.ln2(x)
        if not self.cfg.is_moe:
            if self.ffn_in:
                h = shard.act(h, "ffn_in")
            return x + shard.act(self.mlp(h), "act"), 0.0
        moe = moe_fwd if kv_cache is None else moe_per_row
        out, aux = moe(self.moe, self.cfg, h, shard=shard, counts=counts)
        return x + shard.act(out, "act"), aux


class Decoder(nn.Module):
    """Token embedding, the layers, the final norm and the (tied) head:
    the dense, MoE and VLM families (a VLM's patch embeddings come in as
    ``prefix_embeds``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             "decoder-only stack")
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.embed = weight((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.lm_head = None if cfg.tie_embeddings \
            else weight((cfg.d_model, cfg.vocab), dt, device)

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                last_only: bool = False, fresh: bool = False,
                prefix_embeds: torch.Tensor | None = None, shard=NOSHARD
                ) -> tuple[torch.Tensor, torch.Tensor | float, dict | None]:
        """Returns (logits, aux_loss, new_cache).

        tokens: (B, S) int.  cache: {"k"/"v": (L,B,kv_len,Hkv,hd), "kpos":
        (B,kv_len), "pos": (B,), "page_size": int} for serving; its k/v are
        written in place and the returned cache shares them.  An MoE
        cache may carry ``"expert_counts"`` (L, E_h) int64, which each layer
        overwrites with its held experts' pair counts (the serving engine
        adds it).  ``fresh``
        says every row of the cache is at position 0.  prefix_embeds
        (B, F, d) go in front of the token embeddings (cast to the model
        dtype); the positions, the ring and ``pos`` then cover F + S.
        """
        cfg = self.cfg
        x = shard.embed(self.embed, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        x = shard.act(x, "act")
        aux = 0.0
        if cache is None:
            positions = shard.const(torch.arange(x.shape[1], device=x.device))
            for layer in self.layers:
                x, a = remat(cfg, layer, x, positions, None, shard)
                aux = aux + a
            new_cache = None
        else:
            pos = cache["pos"]
            page = cache["page_size"] if cfg.swa_window == 0 else 0
            ring, new_kpos = ring_info(pos, x.shape[1], cache["k"].shape[2],
                                       cache["kpos"], fresh, page, shard)
            counts = cache.get("expert_counts")
            for l, layer in enumerate(self.layers):
                kv = {"k": cache["k"][l], "v": cache["v"][l], **ring}
                x, a = layer(x, ring["q_pos"], kv, shard,
                             None if counts is None else counts[l])
                aux = aux + a
            # advance by the full written slab
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "pos": pos + x.shape[1], "kpos": new_kpos,
                         "page_size": cache["page_size"]}
        if last_only:
            x = x[:, -1:]      # serving prefill: head for last token only
        x = self.ln_f(x)
        head = self.embed.t() if self.lm_head is None else self.lm_head
        return shard.act(x @ head.to(x.dtype), "logits"), aux, new_cache


class Hybrid(nn.Module):
    """zamba2: embedding; ``n_layers // attn_every`` super-blocks of
    ``attn_every`` Mamba2 layers, each followed by the one shared
    attention+MLP block (a ``DecoderLayer``: the same pre-norm residual
    structure); ``n_layers % attn_every`` tail layers; final norm and an
    untied head."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: not a hybrid config")
        self.cfg = cfg
        dt = dtype_of(cfg)
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        self.embed = weight((cfg.vocab, cfg.d_model), dt, device)
        self.blocks = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, device)
                          for _ in range(cfg.attn_every))
            for _ in range(n_super))
        self.shared = DecoderLayer(cfg, device, ffn_in=False)
        self.tail = nn.ModuleList(MambaLayer(cfg, device)
                                  for _ in range(n_tail))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.lm_head = weight((cfg.d_model, cfg.vocab), dt, device)

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                last_only: bool = False, fresh: bool = False, shard=NOSHARD
                ) -> tuple[torch.Tensor, float, dict | None]:
        """Returns (logits, 0.0, new_cache).

        cache: {"ssm": (n_super, attn_every, B, H, P, N) f32, "ssm_tail":
        (n_tail, B, H, P, N) f32 (with a tail), "k"/"v": (n_super, B,
        max_seq, Hkv, hd), "kpos": (B, max_seq), "pos": (B,), "page_size":
        int}; states, k and v are written in place and the returned cache
        shares them.  One token steps every Mamba2 state; a longer slab
        scans from it (the SSD kernel).  ``fresh`` says every row of the
        cache is at position 0.
        """
        cfg = self.cfg
        x = shard.act(shard.embed(self.embed, tokens), "act")
        if cache is None:
            positions = shard.const(torch.arange(x.shape[1], device=x.device))
            for block in self.blocks:
                for layer in block:
                    x = remat(cfg, layer, x, None, shard)
                x, _ = self.shared(x, positions, None, shard)
            for layer in self.tail:
                x = remat(cfg, layer, x, None, shard)
            new_cache = None
        else:
            pos = cache["pos"]
            page = cache["page_size"] if cfg.swa_window == 0 else 0
            ring, new_kpos = ring_info(pos, x.shape[1], cache["k"].shape[2],
                                       cache["kpos"], fresh, page, shard)
            for i, block in enumerate(self.blocks):
                for j, layer in enumerate(block):
                    x = layer(x, cache["ssm"][i, j], shard)
                kv = {"k": cache["k"][i], "v": cache["v"][i], **ring}
                x, _ = self.shared(x, ring["q_pos"], kv, shard)
            for j, layer in enumerate(self.tail):
                x = layer(x, cache["ssm_tail"][j], shard)
            new_cache = dict(cache, pos=pos + x.shape[1], kpos=new_kpos)
        if last_only:
            x = x[:, -1:]      # serving prefill: head for last token only
        x = self.ln_f(x)
        return shard.act(x @ self.lm_head, "logits"), 0.0, new_cache


class AttentionLayer(nn.Module):
    """A pattern stack's attention layer: pre-norm attention, residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype_of(cfg), device)
        self.attn = Attention(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache: dict | None = None) -> torch.Tensor:
        return x + self.attn(self.ln(x), positions, kv_cache)


class MoELayer(nn.Module):
    """A pattern stack's expert layer: pre-norm ``MoE``, residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype_of(cfg), device)
        self.moe = MoE(cfg, device)

    def forward(self, x: torch.Tensor, per_row: bool = False,
                counts: torch.Tensor | None = None) -> torch.Tensor:
        """``per_row``: each row forms its own groups (serving)."""
        moe = moe_per_row if per_row else moe_fwd
        return x + moe(self.moe, self.cfg, self.ln(x), counts=counts)[0]


PATTERN_LAYERS = {"M": MambaLayer, "E": MoELayer, "*": AttentionLayer}


class NemotronH(nn.Module):
    """nemotron_h: embedding; one layer per character of
    ``cfg.layer_pattern`` (M: pre-norm Mamba2, E: pre-norm MoE, *: pre-norm
    attention, each with a residual); final norm and an untied head.  Runs
    unsharded (``shard`` must be ``NOSHARD``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        if cfg.family != "nemotron_h" or not cfg.layer_pattern:
            raise ValueError(f"{cfg.name}: not a layer-pattern config")
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.embed = weight((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(PATTERN_LAYERS[c](cfg, device)
                                    for c in cfg.layer_pattern)
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.lm_head = weight((cfg.d_model, cfg.vocab), dt, device)

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                last_only: bool = False, fresh: bool = False, shard=NOSHARD
                ) -> tuple[torch.Tensor, float, dict | None]:
        """Returns (logits, 0.0, new_cache).

        cache: {"ssm_state": (M, B, H, P, N) f32 and "conv_state" (M, B,
        taps - 1, di + 2 G N) per Mamba2 layer, "k"/"v": (A, B, max_seq,
        Hkv, hd) per attention layer, "kpos", "pos", "page_size", and
        optionally "expert_counts" (E, E_h) int64 per MoE layer}; every
        state is written in place and the returned cache shares them.  One
        token steps every Mamba2 layer; a longer slab runs its conv and
        scans (the SSD kernel) from the cached states.
        """
        if shard.sharded:
            raise NotImplementedError(f"{self.cfg.name}: a layer-pattern "
                                      "stack runs unsharded")
        cfg = self.cfg
        x = shard.embed(self.embed, tokens)
        if cache is None:
            positions = torch.arange(x.shape[1], device=x.device)
            for layer in self.layers:
                if isinstance(layer, AttentionLayer):
                    x = remat(cfg, layer, x, positions)
                else:
                    x = remat(cfg, layer, x)
            new_cache = None
        else:
            pos = cache["pos"]
            ring, new_kpos = ring_info(pos, x.shape[1], cache["k"].shape[2],
                                       cache["kpos"], fresh,
                                       cache["page_size"])
            counts = cache.get("expert_counts")
            seen = dict.fromkeys(PATTERN_LAYERS, 0)
            for c, layer in zip(cfg.layer_pattern, self.layers):
                i = seen[c]
                seen[c] += 1
                if c == "M":
                    x = layer(x, cache["ssm_state"][i],
                              conv=cache["conv_state"][i])
                elif c == "E":
                    x = layer(x, True, None if counts is None
                              else counts[i])
                else:
                    kv = {"k": cache["k"][i], "v": cache["v"][i], **ring}
                    x = layer(x, ring["q_pos"], kv)
            new_cache = dict(cache, pos=pos + x.shape[1], kpos=new_kpos)
        if last_only:
            x = x[:, -1:]      # serving prefill: head for last token only
        return self.ln_f(x) @ self.lm_head, 0.0, new_cache


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention and SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                shard=NOSHARD) -> torch.Tensor:
        h = self.ln1(x)
        x = x + shard.act(self.attn(h, positions, kv_source=h, shard=shard),
                          "act")
        return x + shard.act(self.mlp(self.ln2(x)), "act")


class CrossDecoderLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the encoder
    output (``xattn``, after ``ln_x``) and SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = Attention(cfg, device)
        self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.xattn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor,
                positions: torch.Tensor, kv_cache: dict | None = None,
                shard=NOSHARD) -> torch.Tensor:
        x = x + shard.act(self.attn(self.ln1(x), positions, kv_cache,
                                    shard=shard), "act")
        x = x + shard.act(self.xattn(self.ln_x(x), positions,
                                     kv_source=enc_out, shard=shard), "act")
        return x + shard.act(self.mlp(self.ln2(x)), "act")


class EncDec(nn.Module):
    """seamless-m4t: a bidirectional encoder over the frontend's frame
    embeddings (``encoder``, then ``ln_enc``) and a causal decoder with
    cross-attention (``decoder``), a token embedding, ``ln_f`` and an
    untied head."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: not an encoder-decoder config")
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.embed = weight((cfg.vocab, cfg.d_model), dt, device)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device)
                                     for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(CrossDecoderLayer(cfg, device)
                                     for _ in range(cfg.n_layers))
        self.ln_enc = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.lm_head = weight((cfg.d_model, cfg.vocab), dt, device)

    def encode(self, src_embeds: torch.Tensor,
               shard=NOSHARD) -> torch.Tensor:
        """Frame embeddings (B, F, d) -> encoder output (B, F, d)."""
        x = shard.act(src_embeds.to(self.embed.dtype), "act")
        positions = shard.const(torch.arange(x.shape[1], device=x.device))
        for layer in self.encoder:
            x = remat(self.cfg, layer, x, positions, shard)
        return self.ln_enc(x)

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                cache: dict | None = None, last_only: bool = False,
                fresh: bool = False, shard=NOSHARD
                ) -> tuple[torch.Tensor, float, dict | None]:
        """Returns (logits, 0.0, new_cache); the cache is the decoder's, as
        ``Decoder.forward``'s (the caller keeps ``enc_out`` beside it)."""
        x = shard.act(shard.embed(self.embed, tokens), "act")
        if cache is None:
            positions = shard.const(torch.arange(x.shape[1], device=x.device))
            for layer in self.decoder:
                x = remat(self.cfg, layer, x, enc_out, positions, None,
                          shard)
            new_cache = None
        else:
            pos = cache["pos"]
            ring, new_kpos = ring_info(pos, x.shape[1], cache["k"].shape[2],
                                       cache["kpos"], fresh,
                                       cache["page_size"], shard)
            for l, layer in enumerate(self.decoder):
                kv = {"k": cache["k"][l], "v": cache["v"][l], **ring}
                x = layer(x, enc_out, ring["q_pos"], kv, shard)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "pos": pos + x.shape[1], "kpos": new_kpos,
                         "page_size": cache["page_size"]}
        if last_only:
            x = x[:, -1:]      # serving prefill: head for last token only
        return shard.act(self.ln_f(x) @ self.lm_head, "logits"), 0.0, \
            new_cache


class XLSTM(nn.Module):
    """xLSTM: embedding, ``n_layers // 2`` (mLSTM, sLSTM) pairs, final norm
    and an untied head.  No attention, so no kernel: every step is plain
    PyTorch ops, as every step is jnp in the JAX package."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        if not (cfg.family == "ssm" and cfg.xlstm):
            raise ValueError(f"{cfg.name}: not an xLSTM config")
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.embed = weight((cfg.vocab, cfg.d_model), dt, device)
        self.pairs = nn.ModuleList(XLSTMPair(cfg, device)
                                   for _ in range(cfg.n_layers // 2))
        self.ln_f = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.lm_head = weight((cfg.d_model, cfg.vocab), dt, device)

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                last_only: bool = False, fresh: bool = False, shard=NOSHARD
                ) -> tuple[torch.Tensor, float, dict | None]:
        """Returns (logits, 0.0, new_cache).  cache: {"mlstm_C" (P, B, h, dh,
        dh), "mlstm_n" (P, B, h, dh), "mlstm_m" (P, B, h), "slstm_c"/"_n"/
        "_h"/"_m" (P, B, d), all f32, "pos" (B,)}, P the pairs; the states
        are written in place and the returned cache shares them.  Every
        row's recurrence starts from its own state, so ``fresh`` changes
        nothing."""
        x = shard.act(shard.embed(self.embed, tokens), "act")
        for i, pair in enumerate(self.pairs):
            if cache is None:
                x = remat(self.cfg, pair, x, None, shard)
            else:
                x = pair(x, {k: v[i] for k, v in cache.items()
                             if k != "pos"}, shard)
        new_cache = None if cache is None else dict(
            cache, pos=cache["pos"] + tokens.shape[1])
        if last_only:
            x = x[:, -1:]      # serving prefill: head for last token only
        return shard.act(self.ln_f(x) @ self.lm_head, "logits"), 0.0, \
            new_cache


def seeded_init(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill any of the stacks with the JAX package's scheme: embedding
    N(0, 0.02), every other weight of two or more axes N(0, 1/fan_in) with
    fan_in its next-to-last axis (a dense ``(in, out)`` weight's ``in``, an
    expert's ``(E, d, f)`` d and ``(E, f, d)`` f, the sLSTM's recurrent
    ``(h, dh, 4dh)`` dh).  Norm scales and 1-D parameters keep the values
    the modules set: 1 for norms; a Mamba2 layer's f32 ``A_log`` =
    log(linspace(1, 16, h)), ``D`` = 1, ``dt_bias`` = 0; an mLSTM's
    ``f_bias`` and the sLSTM's forget-gate ``bias`` quarter 3.0.  Numbers
    are drawn in f32 on the CPU from ``generator``, in parameter order, so
    a seed gives the same weights on every device."""

    @torch.no_grad()
    def fill(param: nn.Parameter, std: float) -> None:
        w = torch.randn(param.shape, generator=generator,
                        dtype=torch.float32) * std
        param.copy_(w)

    fill(net.embed, 0.02)
    for name, param in net.named_parameters():
        if name != "embed" and param.dim() >= 2:
            fill(param, 1.0 / math.sqrt(param.shape[-2]))
    return net
