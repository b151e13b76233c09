"""The zamba2 hybrid in plain float32, as the configuration file states the
port's architecture: the token embedding; ``n_layers // attn_every``
super-blocks of ``attn_every`` pre-norm Mamba2 layers, each followed by the
ONE shared pre-norm attention + SwiGLU block (the same weights at every
application); ``n_layers % attn_every`` tail Mamba2 layers; the final
RMSNorm and an untied head.

A Mamba2 layer: ``in_proj`` (d, 2 di + 2 n + h) splits into z, x, B, C and
dt; dt = softplus(dt + dt_bias); the log-decay a = dt * -exp(A_log); the
input x is scaled by dt per head (h heads of p); one B and one C shared by
every head; the scan s_t = exp(a_t) s_{t-1} + x_t B_t^T, y_t = s_t C_t from
a zero state; y += D * x (the dt-scaled x); y is RMS-normed over di, gated
by silu(z) and projected by ``out_proj``.  No convolution, no biases.

The scan is computed in the chunked form, each chunk's decays as sums over
the steps inside it (a "segment sum"), so that no difference of two long
cumulative sums loses digits.

``counts`` states the work of one token for the yardstick
(``bench/work.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.layers import (attention, attention_weights, f32,
                                    head, heads, rmsnorm, swiglu)
from bench.work import Counts

CHUNK = 64


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)                       # x[i, j] = a[i]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    s = x.masked_fill(~below, 0.0).cumsum(dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor) -> torch.Tensor:
    """x (b, l, h, p), a (b, l, h), B/C (b, l, n) -> y (b, l, h, p), the
    scan from a zero state."""
    b, l, h, p = x.shape
    pad = -l % CHUNK
    if pad:
        x, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, B, C))
        a = F.pad(a, (0, 0, 0, pad))
    c = x.shape[1] // CHUNK
    x = x.view(b, c, CHUNK, h, p)
    B = B.view(b, c, CHUNK, -1)
    C = C.view(b, c, CHUNK, -1)
    a = a.view(b, c, CHUNK, h).permute(0, 3, 1, 2)             # (b,h,c,T)
    acum = a.cumsum(-1)
    decay = torch.exp(segsum(a))                               # (b,h,c,T,T)
    cb = torch.einsum("bcln,bcsn->bcls", C, B)
    y = torch.einsum("bhcls,bcshp->bclhp", decay * cb[:, None], x)
    # each chunk's own final state, then the states passed across chunks
    to_end = torch.exp(acum[..., -1:] - acum)                  # (b,h,c,T)
    states = torch.einsum("bcsn,bhcs,bcshp->bchpn", B, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(acum[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(acum))
    return y.reshape(b, c * CHUNK, h, p)[:, :l]


def mamba(u: torch.Tensor, p: dict, run: dict) -> torch.Tensor:
    b, l, d = u.shape
    di = run["ssm_expand"] * d
    n, hp = run["ssm_state"], run["ssm_head_dim"]
    h = di // hp
    proj = u @ f32(p["in_proj"])
    z, x = proj[..., :di], proj[..., di:2 * di]
    B, C = proj[..., 2 * di:2 * di + n], proj[..., 2 * di + n:2 * di + 2 * n]
    dt = F.softplus(proj[..., 2 * di + 2 * n:] + f32(p["dt_bias"]))
    a = dt * -torch.exp(f32(p["A_log"]))
    xh = x.view(b, l, h, hp) * dt[..., None]
    y = ssd(xh, a, B, C) + xh * f32(p["D"])[:, None]
    y = rmsnorm(y.reshape(b, l, di), p["norm.scale"], run["norm_eps"])
    return (y * F.silu(z)) @ f32(p["out_proj"])


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def forward(run: dict, params: dict, tokens: torch.Tensor, **_
            ) -> torch.Tensor:
    """tokens (B, L) long -> the last hidden states (B, L, d) before the
    final norm, layer by layer (each layer's weights widened to f32 only
    while it runs)."""
    x = f32(params["embed"])[tokens]
    eps = run["norm_eps"]
    n_super, n_tail = divmod(run["n_layers"], run["attn_every"])
    shared = _sub(params, "shared.")

    def mamba_layer(x, prefix):
        lp = _sub(params, prefix)
        return x + mamba(rmsnorm(x, lp["ln.scale"], eps), _sub(lp, "mamba."),
                         run)

    for i in range(n_super):
        for j in range(run["attn_every"]):
            x = mamba_layer(x, f"blocks.{i}.{j}.")
        x = x + attention(rmsnorm(x, shared["ln1.scale"], eps),
                          _sub(shared, "attn."), run)
        x = x + swiglu(rmsnorm(x, shared["ln2.scale"], eps),
                       shared["mlp.w_gate"], shared["mlp.w_up"],
                       shared["mlp.w_down"])
    for j in range(n_tail):
        x = mamba_layer(x, f"tail.{j}.")
    return x


def logits(run: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    return head(x, run, params["ln_f.scale"], params["lm_head"])


def counts(run: dict) -> Counts:
    """Per Mamba2 layer ``in_proj`` (d, 2 di + 2 n + h) and ``out_proj``
    (di, d), its SSD scan (h heads of p, state n, one B/C group) and the
    recurrence's 4 h p n FLOPs a token (decay and update of the state, and
    its read); per application of the shared block (``n_layers //
    attn_every``) its attention and SwiGLU; the head d x vocab."""
    d = run["d_model"]
    di = run["ssm_expand"] * d
    n, p = run["ssm_state"], run["ssm_head_dim"]
    h = di // p
    mamba = d * (2 * di + 2 * n + h) + di * d
    shared = attention_weights(run) + 3 * d * run["d_ff"]
    apps = run["n_layers"] // run["attn_every"]
    return Counts(weights=run["n_layers"] * mamba + apps * shared,
                  head=d * run["vocab"],
                  attention=((apps, *heads(run)),),
                  ssd=((run["n_layers"], h, p, n, 1),),
                  other_flops=4.0 * h * p * n * run["n_layers"])
