"""Mixture-of-Experts layer: shared experts plus routed top-k experts with
GShard-style per-group capacity (qwen2-moe: 60 routed top-4 and 4 shared;
granite-moe: 40 routed top-8, no shared), and the router's aux losses
(Switch load balancing and z-loss).

Counterpart of the JAX package's ``moe.py``: ``MoE`` holds ``moe_init``'s
leaves under the same names, and ``moe_fwd`` computes ``moe_fwd`` on the
same ``(B, S, d)`` input: the same groups (a ragged tail padded into the
last one), the same f32 router, aux losses over every row of the groups,
the same top-k gates and capacity, and the same drop order.  The dispatch
is written in PyTorch's idiom rather than as the TPU's one-hot einsums:
one stable sort of the (token, choice) pairs by (expert, group) gives each
pair its slot in its expert and lines the pairs up expert by expert; three
grouped matmuls (``F.grouped_mm``) run each expert's SwiGLU on its own
rows only, so an expert that received no pair reads none of its weights;
each token's k outputs are weighted by their gates (0 for a dropped pair)
and summed in choice order, with no atomics.  Nothing is read back to the
host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, dtype_of, mlp_fwd, weight

MOE_GROUP = 1024   # tokens per dispatch group (GShard/GLaM-style)


class MoE(nn.Module):
    """``router`` (d, E) f32; ``w_gate``/``w_up`` (E, d, f) and ``w_down``
    (E, f, d) in the model dtype; ``shared`` an ``MLP`` of width
    ``n_shared_experts * f`` when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        self.router = weight((d, e), torch.float32, device)
        self.w_gate = weight((e, d, f), dt, device)
        self.w_up = weight((e, d, f), dt, device)
        self.w_down = weight((e, f, d), dt, device)
        self.shared = (MLP(d, cfg.n_shared_experts * f, dt, device)
                       if cfg.n_shared_experts > 0 else None)


def _expert_swiglu(p: MoE, rows: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """rows (N, d) lined up expert by expert, ``offs`` (E,) int32 the end
    of each expert's rows -> each row through its expert's SwiGLU, (N, d)
    in the rows' dtype.  The casts are ``mlp_fwd``'s: products in the
    model dtype (accumulated in f32), the gate and its product in f32."""
    gate = F.silu(F.grouped_mm(rows, p.w_gate, offs=offs).float())
    up = F.grouped_mm(rows, p.w_up, offs=offs).float()
    hidden = (gate * up).to(rows.dtype)
    return F.grouped_mm(hidden, p.w_down, offs=offs)


def moe_fwd(p: MoE, cfg: ModelConfig, x: torch.Tensor,
            group_size: int = MOE_GROUP
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar).

    The B * S tokens form groups of ``min(group_size, B * S)`` in order;
    each expert takes at most ``cap`` (token, choice) pairs of a group,
    counted in token-major, choice-minor order with the choices in
    descending gate order, and drops the rest."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    group = min(group_size, t)
    n_g = -(-t // group)
    xt = x.reshape(t, d)
    if n_g * group != t:
        # ragged tail folds into the last group's capacity headroom
        xt = F.pad(xt, (0, 0, 0, n_g * group - t))

    logits = xt.float().reshape(n_g, group, d) @ p.router     # (G, g, E)
    probs = torch.softmax(logits, dim=-1)

    # --- aux losses (over every row of the groups, padding included) ---
    top1 = F.one_hot(probs.argmax(dim=-1), e).float()
    aux = cfg.router_aux_coef * e * torch.sum(top1.mean(dim=(0, 1))
                                              * probs.mean(dim=(0, 1)))
    z = cfg.router_z_coef * torch.logsumexp(logits, dim=-1).square().mean()

    # --- top-k routing with per-group capacity ---
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)     # (G, g, k)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    cap = int(max(k, round(group * cfg.capacity_factor * k / e)))

    # pair j = (token, choice) = (j // k, j % k) over all groups.  A stable
    # sort by (expert, group) keeps each run in token-major, choice-minor
    # order, so a pair's rank in its run is its slot in the expert.
    n = n_g * group * k
    pair_group = torch.arange(n, device=x.device) // (group * k)
    key = idx.reshape(n) * n_g + pair_group
    key_sorted, order = torch.sort(key, stable=True)
    counts = torch.zeros(e * n_g, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = counts.cumsum(0) - counts
    slot = torch.arange(n, device=x.device) - starts[key_sorted]
    keep = torch.empty_like(slot).scatter_(0, order, slot) < cap

    # every pair runs through its expert (a dropped one is weighted 0)
    offs = counts.view(e, n_g).sum(dim=1).cumsum(0).to(torch.int32)
    y_sorted = _expert_swiglu(p, xt[order // k], offs)
    y = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    weights = torch.where(keep, gate.reshape(n), 0.0)
    out = (y.float().view(-1, k, d) * weights.view(-1, k, 1)).sum(dim=1)
    out = out[:t].to(x.dtype)

    if p.shared is not None:
        out = out + mlp_fwd(p.shared, xt[:t])
    return out.reshape(b, s, d), aux + z


def moe_per_row(p: MoE, cfg: ModelConfig, x: torch.Tensor,
                group_size: int = MOE_GROUP
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_fwd`` with each row of x (B, S, d) forming its own groups, as
    the JAX package's engine has it (it maps the one-sequence model over
    the slots): a decode step's token is a group of one, dropless.  Each
    row is padded at its end to whole groups; one call serves all rows.
    The aux loss is taken over all rows' groups together."""
    b, s, d = x.shape
    group = min(group_size, s)
    n_g = -(-s // group)
    if n_g * group != s:
        x = F.pad(x, (0, 0, 0, n_g * group - s))
    out, aux = moe_fwd(p, cfg, x.reshape(b * n_g, group, d), group)
    return out.reshape(b, n_g * group, d)[:, :s], aux
