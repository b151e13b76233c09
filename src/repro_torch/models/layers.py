"""Core transformer layers: RMSNorm, RoPE, GQA attention (SWA / qk-norm;
self-, bidirectional or cross-attention; no RoPE where ``rope_theta`` is
0), SwiGLU MLP, and the port's squared-ReLU MLP (nemotron_h's experts).

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

Every function takes a Sharder (``shard``, default ``NOSHARD``: the plain
ops, unchanged).  Under ``parallel.sharding.MeshRules`` the tensors are
DTensors, attention runs on each rank's local heads, and attention over a
cache runs as that module's docstring describes (a distributed softmax over
the sequence-sharded cache).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import NOSHARD, P, axis_size, fit


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
                kv_source: torch.Tensor | None = None,
                shard=NOSHARD) -> torch.Tensor:
        return attention_fwd(self, self.cfg, x, positions, kv_cache,
                             use_kernel, kv_source, shard)


def on_heads(shard, fn, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` -> (B, Sq, Hq, D) on each rank's local batch rows
    and heads: heads over 'model' when both head counts divide it, else
    every head on every rank of 'model'."""
    if not shard.sharded:
        return fn(q, k, v)
    m = axis_size(shard.mesh, "model")
    heads = "model" if q.shape[2] % m == 0 and k.shape[2] % m == 0 else None
    spec = (shard.batch_axes, None, heads, None)
    return shard.local(fn, (q, k, v), (spec,) * 3,
                       fit(shard.mesh, tuple(q.shape), spec))


def attention_fwd(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kv_cache: dict | None = None,
                  use_kernel: bool = False,
                  kv_source: torch.Tensor | None = None,
                  shard=NOSHARD) -> torch.Tensor:
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
    ``use_kernel`` or ``cfg.use_kernels`` asks for it.  Under a mesh the
    attention runs on local heads (``on_heads``) and a cache is written
    and read by ``sharded_cache_attention``.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    src = x if kv_source is None else kv_source
    q = shard.heads(x @ p.wq, (b, s, cfg.n_heads, hd))
    k = shard.heads(src @ p.wk, (b, src.shape[1], cfg.n_kv_heads, hd))
    v = shard.heads(src @ p.wv, (b, src.shape[1], cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if kv_source is None and cfg.rope_theta:  # RoPE: self-attention only
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_source is not None:
        if not k.shape[1]:
            out = q.new_zeros(q.shape)
        elif torch.is_grad_enabled():
            # training attends through sdpa, as the JAX package does at
            # every step: the flash kernel has no backward
            out = on_heads(shard, lambda q, k, v: sdpa(q, k, v, None),
                           q, k, v)
        else:
            out = on_heads(shard, lambda q, k, v: ops.flash_attention(
                q, k, v, causal=False), q, k, v)
    elif kv_cache is not None and shard.sharded:
        out = sharded_cache_attention(cfg, q, k, v, kv_cache, shard)
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
        out = on_heads(shard, lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, window=cfg.swa_window), q, k, v)
    else:
        out = on_heads(shard, lambda q, k, v: sdpa(
            q, k, v, causal_mask(s, s, cfg.swa_window, 0, q.device)),
            q, k, v)
    return out.reshape(b, s, cfg.n_heads * hd) @ p.wo


# ----------------------------------------------------------------------
# Attention over a sequence-sharded cache (under a mesh)
# ----------------------------------------------------------------------

def ring_write(buf: torch.Tensor, vals: torch.Tensor, pos: torch.Tensor,
               kv_len: int, offset: int) -> torch.Tensor:
    """Write a step's values into one rank's slice of a ring, in place.

    buf (B, S_l, ...) holds the ring's slots offset .. offset + S_l - 1 of
    kv_len; vals (B, s, ...) are positions pos .. pos + s - 1 (pos (B,)).
    As ``transformer.ring_info`` writes them: slot = position % kv_len when
    s < kv_len, else the slab's last kv_len tokens in slots 0 .. kv_len - 1.
    One token (decode) is scattered to its slot on the rank that holds it
    (the others write back what the slot held); a slab, each slot gathers
    the token that lands on it.  No shape depends on the data, so the meta
    device runs it too."""
    bl, sl = buf.shape[:2]
    s = vals.shape[1]
    tail = (1,) * (vals.dim() - 2)
    if s == 1 and kv_len > 1:
        slot = pos.long() % kv_len - offset                        # (B,)
        mine = (slot >= 0) & (slot < sl)
        idx = torch.clamp(slot, 0, sl - 1).view(bl, 1, *tail).expand(
            bl, 1, *vals.shape[2:])
        old = torch.gather(buf, 1, idx)
        new = torch.where(mine.view(bl, 1, *tail), vals.to(buf.dtype), old)
        return buf.scatter_(1, idx, new)
    j = torch.arange(offset, offset + sl, device=buf.device)
    if s >= kv_len:
        t = (j + (s - kv_len)).expand(bl, sl)
        valid = torch.ones((bl, sl), dtype=torch.bool, device=buf.device)
    else:
        t = (j[None, :] - pos[:, None].long()) % kv_len
        valid = t < s
        t = torch.clamp(t, max=s - 1)
    idx = t.view(bl, sl, *tail).expand(bl, sl, *vals.shape[2:])
    new = torch.gather(vals.to(buf.dtype), 1, idx)
    buf.copy_(torch.where(valid.view(bl, sl, *tail), new, buf))
    return buf


def cache_slice(shard, shape: tuple[int, ...]) -> tuple[P, int]:
    """A cache tensor's (B, kv_len, ...) spec under ``shard`` and the first
    slot of this rank's slice."""
    spec = fit(shard.mesh, shape, (shard.batch_axes, "model")
               + (None,) * (len(shape) - 2))
    sl = shape[1] // axis_size(shard.mesh, spec[1])
    return spec, (shard.axis_index("model") * sl if spec[1] else 0)


def sdpa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``sdpa`` over a slice of the keys, unnormalised across slices: the
    output (B, Sq, Hq, D) f32 of the slice and each row's log-sum-exp
    (B, Sq, Hq) f32 (-inf, and a zero output, where the slice holds no key
    of the row).  mask: (B, Sq, Skv)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = (logits / math.sqrt(d)).masked_fill(~mask[:, None, None],
                                                  -math.inf)
    lse = torch.logsumexp(logits, dim=-1)                   # (B,Hkv,G,Sq)
    probs = torch.exp(logits - lse[..., None]).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d), lse.permute(0, 3, 1, 2).reshape(
        b, sq, hq)


def merge_slices(shard, out: torch.Tensor, lse: torch.Tensor
                 ) -> torch.Tensor:
    """Merge each rank's (out (B, s, Hq, D), lse (B, s, Hq)) of its slice
    of the keys over 'model': one all-reduce max of lse, one all-reduce sum
    of the weighted outputs and weights.  f32."""
    top = shard.reduce(lse, "max", "model")
    w = torch.where(torch.isfinite(top), torch.exp(lse - top), 0.0)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    packed = shard.reduce(packed, "sum", "model")
    return packed[..., :-1] / packed[..., -1:].clamp(min=1e-30)


def sharded_cache_attention(cfg: ModelConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            kv_cache: dict, shard) -> torch.Tensor:
    """``attention_fwd``'s cache branch under a mesh.  The cache (B, kv_len,
    Hkv, D) shards its sequence over 'model'; each rank writes the slots of
    its slice (``ring_write``).  A slab that fills the ring, or a fresh
    cache, attends in-slab on local heads (flash kernel).  Otherwise each
    rank attends its slice of the cache -- the paged kernel with its
    log-sum-exp on its local lengths clamp(pos + 1 - offset, 0, S_l), or the
    kpos-masked softmax -- and the slices merge (``merge_slices``)."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    b, s, hq, d = q.shape
    kv_len = ck.shape[1]
    ba = shard.batch_axes
    cspec, offset = cache_slice(shard, tuple(ck.shape))
    rows = (ba, None, None, None)
    pos = kv_cache["q_pos"][:, 0]
    for buf, new in ((ck, k), (cv, v)):
        shard.local(lambda buf, new, pos: ring_write(buf, new, pos, kv_len,
                                                     offset),
                    (buf, new, pos), (cspec, rows, (ba,)), cspec)
    if s >= kv_len or kv_cache["fresh"]:
        return on_heads(shard, lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, window=cfg.swa_window), q, k, v)
    page = kv_cache.get("page_size", 0)
    sl = ck.shape[1] // axis_size(shard.mesh, cspec[1])
    paged = s == 1 and page and sl % page == 0

    def attend(q, ck, cv, kpos, q_pos):
        bl = q.shape[0]
        if paged:
            lengths = torch.clamp(q_pos[:, 0] + 1, max=kv_len) - offset
            lengths = torch.clamp(lengths, 0, sl).to(torch.int32)
            view = (bl * sl // page, page) + tuple(ck.shape[2:])
            table = torch.arange(bl * sl // page, dtype=torch.int32,
                                 device=q.device).view(bl, sl // page)
            o, lse = ops.paged_attention(q.reshape(bl, hq, d), ck.view(view),
                                         cv.view(view), table, lengths,
                                         return_lse=True)
            o, lse = o[:, None], lse[:, None]
        else:
            kp = kpos[:, None, :]
            qp = q_pos[:, :, None]
            mask = (kp >= 0) & (kp <= qp)
            if cfg.swa_window > 0:
                mask &= kp > qp - cfg.swa_window
            o, lse = sdpa_lse(q, ck, cv, mask)
        return merge_slices(shard, o, lse).to(q.dtype)

    kspec = cspec[:2]
    return shard.local(attend, (q, ck, cv, kv_cache["kpos"],
                                kv_cache["q_pos"]),
                       (rows, cspec, cspec, kspec, (ba, None)),
                       fit(shard.mesh, tuple(q.shape), rows))


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


class Relu2MLP(nn.Module):
    """x -> relu(x @ w_up)^2 @ w_down: no gate matrix.  The square is taken
    in f32 and rounded to the model dtype, as ``mlp_fwd``'s activation."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.w_up = weight((d_model, d_ff), dtype, device)
        self.w_down = weight((d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w_up).square() @ self.w_down
