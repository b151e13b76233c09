"""Plain PyTorch oracles for the kernels (the correctness references).

Each function is the semantics its CUDA kernel must match.  Attention: f32
math, a -inf mask, and zeros (not NaN) for a fully masked row.  SSD scan:
the sequential state recurrence, state in f32.  On a CPU tensor the ``ops``
entry points run the attention oracles; the SSD scan's plain version is the
chunked form (``ssd_scan.ssd_scan_plain``), which this recurrence checks.
"""

from __future__ import annotations

import math

import torch


def _repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _softmax_zero_masked(s: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(s, dim=-1)
    return torch.where(torch.isnan(p), torch.zeros_like(p), p)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    k = _repeat_kv(k, hq // hkv).float()
    v = _repeat_kv(v, hq // hkv).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask[None, None], -math.inf)
    p = _softmax_zero_masked(s)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, return_lse: bool = False):
    """Decode attention over a paged KV cache.

    q:           (B, Hq, D)        one query token per sequence
    k/v_pages:   (P, page, Hkv, D) physical page pool
    block_table: (B, pages_per_seq) int32 physical page ids
    lengths:     (B,) int32 current sequence lengths
    returns      (B, Hq, D), and with ``return_lse`` the log-sum-exp of
                 each head's scaled scores (B, Hq) f32, -inf at length 0
    """
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    per_seq = block_table.shape[1]
    g = hq // hkv
    table = block_table.long()
    # gather each sequence's logical KV: (B, per_seq*page, Hkv, D)
    k = k_pages[table].reshape(b, per_seq * page, hkv, d)
    v = v_pages[table].reshape(b, per_seq * page, hkv, d)
    k = _repeat_kv(k, g).float()
    v = _repeat_kv(v, g).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) / math.sqrt(d)
    pos = torch.arange(per_seq * page, device=q.device)[None, :]
    mask = pos < lengths.to(q.device).long()[:, None]
    s = s.masked_fill(~mask[:, None, :], -math.inf)
    p = _softmax_zero_masked(s)
    out = torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, init_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the exact semantics), one step at a time.

    x: (b, l, h, p); a: (b, l, h) log-decay; B/C: (b, l, n).
    state: (b, h, p, n).  s_t = exp(a_t) s_{t-1} + x_t (x) B_t,
    y_t = C_t . s_t.  Returns y (b, l, h, p) and the final state, f32.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    s = (init_state.float().clone() if init_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=x.device))
    ys = []
    for t in range(l):
        s = s * torch.exp(a[:, t].float())[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t].float(), B[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t].float()))
    return torch.stack(ys, dim=1), s
