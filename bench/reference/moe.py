"""The qwen2-moe decoder in plain float32, as the configuration file states
the port's architecture: the token embedding; ``n_layers`` pre-norm layers
of causal attention (RoPE, no biases) and a mixture of experts; the final
RMSNorm and an untied head.

The mixture: router logits h @ router (f32), softmax, the top-k experts in
descending order, their gates renormalised to sum to one (over sum + 1e-9);
each expert a SwiGLU of width ``expert_d_ff``; the shared experts one SwiGLU
of width ``n_shared_experts * expert_d_ff``, added ungated.  GShard capacity
per group: each expert takes at most cap = max(k, round(g * capacity_factor
* k / E)) of a group's (token, choice) pairs, counted in token-major,
choice-minor order, and drops the rest.  Serving forms the groups so: a
prefill is one group of its whole bucket (left padding included), and each
decoded token is a group of its own (cap = k: nothing drops).  ``forward``
takes that grouping as ``prefill`` (B,): the length of each sequence's
prefill group.  ``counts`` states the work of one token for the yardstick
(``bench/work.py``)."""

from __future__ import annotations

import torch

from bench.reference.layers import (attention, attention_weights, f32,
                                    head, heads, rmsnorm, swiglu)
from bench.work import Counts


def capacity(group: int, run: dict) -> int:
    k, e = run["top_k"], run["n_experts"]
    return int(max(k, round(group * run["capacity_factor"] * k / e)))


def keep_mask(idx: torch.Tensor, cap: int, n_experts: int) -> torch.Tensor:
    """idx (g, k) the experts of a group's pairs -> whether each pair is
    within its expert's capacity (pairs counted token-major)."""
    onehot = torch.nn.functional.one_hot(idx.reshape(-1), n_experts)
    rank = (onehot.cumsum(0) - onehot)[torch.arange(onehot.shape[0]),
                                       idx.reshape(-1)]
    return (rank < cap).view(idx.shape)


def moe(h: torch.Tensor, p: dict, run: dict, prefill: list[int]
        ) -> torch.Tensor:
    b, l, d = h.shape
    k, e = run["top_k"], run["n_experts"]
    probs = (h @ f32(p["router"])).softmax(-1)
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)      # (b, l, k)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    keep = torch.ones_like(gate, dtype=torch.bool)
    for i, g in enumerate(prefill):
        keep[i, :g] = keep_mask(idx[i, :g], capacity(g, run), e)
    weights = torch.where(keep, gate, 0.0)
    flat_h = h.reshape(b * l, d)
    flat_idx = idx.reshape(b * l, k)
    flat_w = weights.reshape(b * l, k)
    out = torch.zeros_like(flat_h)
    for ex in range(e):
        rows, choice = (flat_idx == ex).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(flat_h[rows], p["w_gate"][ex], p["w_up"][ex],
                   p["w_down"][ex])
        out.index_add_(0, rows, y * flat_w[rows, choice][:, None])
    out = out.view(b, l, d)
    if run["n_shared_experts"]:
        out = out + swiglu(h, p["shared.w_gate"], p["shared.w_up"],
                           p["shared.w_down"])
    return out


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def forward(run: dict, params: dict, tokens: torch.Tensor,
            prefill: list[int], **_) -> torch.Tensor:
    """tokens (B, L) long -> the last hidden states (B, L, d) before the
    final norm, layer by layer."""
    x = f32(params["embed"])[tokens]
    eps = run["norm_eps"]
    for i in range(run["n_layers"]):
        lp = _sub(params, f"layers.{i}.")
        x = x + attention(rmsnorm(x, lp["ln1.scale"], eps),
                          _sub(lp, "attn."), run)
        x = x + moe(rmsnorm(x, lp["ln2.scale"], eps), _sub(lp, "moe."), run,
                    prefill)
    return x


def logits(run: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    return head(x, run, params["ln_f.scale"], params["lm_head"])


def counts(run: dict) -> Counts:
    """Per layer its attention, the router (d, E), the top-k routed experts
    and the shared experts (each a SwiGLU of width ``expert_d_ff``); the
    head d x vocab."""
    d, f = run["d_model"], run["expert_d_ff"]
    ffn = d * run["n_experts"] + run["top_k"] * 3 * d * f \
        + run["n_shared_experts"] * 3 * d * f
    return Counts(weights=run["n_layers"] * (attention_weights(run) + ffn),
                  head=d * run["vocab"],
                  attention=((run["n_layers"], *heads(run)),))
