"""Layers the reference modules share, in float32: RMSNorm, half-split RoPE,
causal softmax attention, SwiGLU.  TF32 is switched off by the callers
(``bench/check.py``), so every product here is an IEEE float32 one."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * f32(scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, D) at positions 0 .. L-1: the first and second halves of
    each head rotate as pairs, frequency theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def heads(run: dict) -> tuple[int, int, int]:
    """The attention's query heads, KV heads and head dim."""
    hq = run["n_heads"]
    return hq, run["n_kv_heads"], run["head_dim"] or run["d_model"] // hq


def attention_weights(run: dict) -> int:
    """Weights of the attention's four projections."""
    hq, hkv, hd = heads(run)
    return run["d_model"] * hq * hd * 2 + run["d_model"] * hkv * hd * 2


def attention(h: torch.Tensor, p: dict, run: dict) -> torch.Tensor:
    """Causal GQA self-attention over h (B, L, d) with RoPE, 1/sqrt(D)
    scaling, no biases; the weights are (in, out)."""
    b, l, _ = h.shape
    hq, hkv, hd = heads(run)
    q = rope((h @ f32(p["wq"])).view(b, l, hq, hd), run["rope_theta"])
    k = rope((h @ f32(p["wk"])).view(b, l, hkv, hd), run["rope_theta"])
    v = (h @ f32(p["wv"])).view(b, l, hkv, hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    out = torch.empty((b, l, hq, hd), dtype=torch.float32, device=h.device)
    mask = torch.ones((l, l), dtype=torch.bool, device=h.device).tril()
    for i in range(b):   # one sequence at a time keeps the scores small
        s = torch.einsum("qhd,khd->hqk", q[i], k[i]) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[i] = torch.einsum("hqk,khd->qhd", s, v[i])
    return out.reshape(b, l, hq * hd) @ f32(p["wo"])


def swiglu(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(h @ f32(w_gate)) * (h @ f32(w_up))) @ f32(w_down)


def head(x: torch.Tensor, run: dict, ln_f, lm_head) -> torch.Tensor:
    return rmsnorm(x, ln_f, run["norm_eps"]) @ f32(lm_head)
