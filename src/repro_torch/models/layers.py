"""Core transformer layers: RMSNorm, RoPE, GQA attention (SWA / qk-norm;
self-, bidirectional or cross-attention), SwiGLU MLP.

Plain functions on tensors where the JAX package has plain functions
(``rmsnorm``, ``apply_rope``, ``sdpa``, ``attention_fwd``, ``mlp_fwd``), and
``nn.Module``s that hold the weights and call them.  The cast points are the
JAX package's: matmul inputs stay in the model dtype, attention logits,
softmax, RoPE and norms run in f32.

Conventions:
  activations x : (batch, seq, d_model)
  attention     : q (B,S,Hq,D), k/v (B,S,Hkv,D); GQA by reshape, no repeat
  dense weights : (in, out), as in the JAX package, so a layer is ``x @ w``
  KV cache      : one layer's k/v (B, kv_len, Hkv, D), written in place
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def weight(shape: tuple[int, ...], dtype: torch.dtype,
           device: torch.device) -> nn.Parameter:
    """An uninitialised inference weight; ``transformer.seeded_init`` or
    ``bridge.params_from_jax`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Half-split rotation."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs             # (B,S,D/2)
    if angles.dim() == 2:  # (S, D/2) -> broadcast batch
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]                     # (B,S,1,D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention (GQA + optional SWA + optional qk-norm)
# ----------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, swa: int, q_offset: int,
                device: torch.device) -> torch.Tensor:
    """Boolean mask (q_len, kv_len): True = attend."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if swa > 0:
        mask &= k_pos > q_pos - swa
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention (no KV materialization).

    q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D) with Hq a multiple of Hkv;
    mask: boolean (Sq,Skv) or per row (B,Sq,Skv).  Logits and softmax in
    f32; probabilities cast to v's dtype before the value product, as the
    JAX package does."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(d)
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 \
            else mask[:, None, None]
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        dt = dtype_of(cfg)
        d, hd = cfg.d_model, cfg.hd
        self.wq = weight((d, cfg.n_heads * hd), dt, device)
        self.wk = weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = weight((cfg.n_heads * hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, dt, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, dt, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache: dict | None = None, use_kernel: bool = False,
                kv_source: torch.Tensor | None = None) -> torch.Tensor:
        return attention_fwd(self, self.cfg, x, positions, kv_cache,
                             use_kernel, kv_source)


def attention_fwd(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kv_cache: dict | None = None,
                  use_kernel: bool = False,
                  kv_source: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention with an optional ring-buffer KV cache, or, with
    ``kv_source`` (B, Skv, d), attention of x's queries over keys and values
    projected from it: bidirectional (no mask), no RoPE, no cache, through
    the flash kernel with ``causal=False``, or through ``sdpa`` while a
    gradient is recorded (training; prefill and decode run under
    ``torch.no_grad()``).  That is the encoder's self-attention
    (``kv_source`` = x) and the decoder's cross-attention over the encoder
    output; with no source frames it is zeros, as a softmax over an empty
    axis is in the JAX package.

    kv_cache (built by ``transformer.ring_info`` for the whole step):
        {"k"/"v": (B, kv_len, Hkv, D) this layer's cache, written in place,
         "q_pos": (B, s) absolute positions of the incoming tokens,
         "slots": (B, s) ring slots to write, "kpos": (B, kv_len) absolute
         position per slot AFTER this write (-1 = empty),
         "fresh": True when every row starts at position 0,
         "table"/"lengths"/"page_size": the cache viewed as pages (decode)}
    Which attention runs:
      s >= kv_len  the slab is attended in-slab (causal, window), and only
                   its last kv_len tokens are stored;
      fresh        causal attention over the slab (flash kernel): with every
                   slot empty, the kpos mask reduces to exactly that;
      paged        one token per row over the cache viewed as pages with an
                   identity block table (paged kernel): every written slot
                   holds a position <= the query's, so the length mask is
                   the kpos mask (full attention only);
      otherwise    ``sdpa`` over the cache with the kpos mask.
    Without a cache: causal attention, through the flash kernel when
    ``use_kernel`` or ``cfg.use_kernels`` asks for it.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    src = x if kv_source is None else kv_source
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (src @ p.wk).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    v = (src @ p.wv).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if kv_source is None:      # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_source is not None:
        if not k.shape[1]:
            out = q.new_zeros(q.shape)
        elif torch.is_grad_enabled():
            # training attends through sdpa, as the JAX package does at
            # every step: the flash kernel has no backward
            out = sdpa(q, k, v, None)
        else:
            out = ops.flash_attention(q, k, v, causal=False)
    elif kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        kv_len = ck.shape[1]
        if s >= kv_len:
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.swa_window)
            # in place (the JAX package returns new arrays): the slab's last
            # kv_len tokens become this layer's cache
            ck.copy_(k[:, s - kv_len:])
            cv.copy_(v[:, s - kv_len:])
        else:
            rows = torch.arange(b, device=x.device)[:, None]
            slots = kv_cache["slots"]
            # in place (the JAX package's .at[].set makes a copy)
            ck[rows, slots] = k.to(ck.dtype)
            cv[rows, slots] = v.to(cv.dtype)
            if kv_cache["fresh"]:
                out = ops.flash_attention(q, k, v, causal=True,
                                          window=cfg.swa_window)
            elif "table" in kv_cache:
                page = kv_cache["page_size"]
                pages = (b * kv_len // page, page) + tuple(ck.shape[2:])
                out = ops.paged_attention(
                    q.reshape(b, cfg.n_heads, hd), ck.view(pages),
                    cv.view(pages), kv_cache["table"],
                    kv_cache["lengths"]).reshape(b, 1, cfg.n_heads, hd)
            else:
                kpos = kv_cache["kpos"][:, None, :]          # (B,1,kv_len)
                q_pos = kv_cache["q_pos"][:, :, None]        # (B,s,1)
                mask = (kpos >= 0) & (kpos <= q_pos)
                if cfg.swa_window > 0:
                    mask &= kpos > q_pos - cfg.swa_window
                out = sdpa(q, ck, cv, mask)
    elif use_kernel or cfg.use_kernels:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=cfg.swa_window)
    else:
        out = sdpa(q, k, v, causal_mask(s, s, cfg.swa_window, 0, x.device))
    return out.reshape(b, s, cfg.n_heads * hd) @ p.wo


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.w_gate = weight((d_model, d_ff), dtype, device)
        self.w_up = weight((d_model, d_ff), dtype, device)
        self.w_down = weight((d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_fwd(self, x)


def mlp_fwd(p: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu((x @ p.w_gate).float())
    up = (x @ p.w_up).float()
    return (gate * up).to(x.dtype) @ p.w_down
