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

The port's nemotron_h options (``ModelConfig``): ``router="sigmoid"``, f32
sigmoid scores, the top k of scores plus the correction bias
``router_bias`` (E,), gates the chosen scores over their sum times
``routed_scale``, no aux loss (the bias balances the experts);
``expert_act="relu2"``, experts and shared expert relu(x W_up)^2 W_down;
``experts_held`` < E, a layer that holds experts 0 .. ``experts_held`` - 1
of the E its router scores (expert parallelism's share of one chip): it
routes over all E, sends the pairs of experts it does not hold nowhere, and
runs its own experts alone, so that its output is its experts' part of the
layer's plus the shared expert.
``moe_fwd`` can write each held expert's pair count (``counts``) in place
of a sum it takes anyway.  These options run unsharded.

Under a mesh (``shard``, ``parallel.sharding.MeshRules``) the routed experts
run on local shards (``moe_sharded``): each rank routes its own tokens'
groups, fills the reference's (G, E, C, d) capacity layout (its
``moe_inner`` constraint: groups over DP, experts over 'model') for its
experts only, runs them as batched products and sums its choices; one
all-reduce over 'model' adds the experts' shares.  Every shape is static
there, so the meta device (the dry-run) runs it as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Relu2MLP,
    dtype_of,
    mlp_fwd,
    weight,
)
from repro_torch.parallel.sharding import NOSHARD, P, _axes, axis_size, fit

MOE_GROUP = 1024   # tokens per dispatch group (GShard/GLaM-style)


class MoE(nn.Module):
    """``router`` (d, E) f32 (with sigmoid routing also ``router_bias``
    (E,) f32, 0); ``w_gate`` (SwiGLU only) / ``w_up`` (E_h, d, f) and
    ``w_down`` (E_h, f, d) in the model dtype, E_h the experts held;
    ``shared`` an ``MLP`` (``Relu2MLP``) of width ``cfg.shared_ff`` when
    the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        held = cfg.n_held
        self.router = weight((d, e), torch.float32, device)
        if cfg.router == "sigmoid":
            self.router_bias = nn.Parameter(
                torch.zeros(e, dtype=torch.float32, device=device),
                requires_grad=False)
        if cfg.expert_act == "swiglu":
            self.w_gate = weight((held, d, f), dt, device)
        self.w_up = weight((held, d, f), dt, device)
        self.w_down = weight((held, f, d), dt, device)
        ffn = Relu2MLP if cfg.expert_act == "relu2" else MLP
        self.shared = (ffn(d, cfg.shared_ff, dt, device)
                       if cfg.n_shared_experts > 0 else None)


def _expert_ffn(p: MoE, rows: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """rows (N, d) lined up expert by expert, ``offs`` (E_h,) int32 the end
    of each held expert's rows -> each row through its expert's SwiGLU (or
    relu², without ``w_gate``), (N, d) in the rows' dtype; rows past the
    last end are no expert's.  The casts are ``mlp_fwd``'s: products in the
    model dtype (accumulated in f32), the activation in f32."""
    if not hasattr(p, "w_gate"):
        up = F.grouped_mm(rows, p.w_up, offs=offs)
        return F.grouped_mm(torch.relu(up).square(), p.w_down, offs=offs)
    gate = F.silu(F.grouped_mm(rows, p.w_gate, offs=offs).float())
    up = F.grouped_mm(rows, p.w_up, offs=offs).float()
    hidden = (gate * up).to(rows.dtype)
    return F.grouped_mm(hidden, p.w_down, offs=offs)


def moe_fwd(p: MoE, cfg: ModelConfig, x: torch.Tensor,
            group_size: int = MOE_GROUP, shard=NOSHARD,
            counts: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar; the float 0.0
    for sigmoid routing).

    The B * S tokens form groups of ``min(group_size, B * S)`` in order;
    each expert takes at most ``cap`` (token, choice) pairs of a group,
    counted in token-major, choice-minor order with the choices in
    descending gate order, and drops the rest.  ``counts`` (E_h,) int64
    receives the pairs routed to each held expert, dropped ones
    included."""
    if shard.sharded:
        return moe_sharded(p, cfg, x, group_size, shard)
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
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        idx = torch.topk(scores + p.router_bias, k, dim=-1,
                         sorted=True).indices                  # (G, g, k)
        gate = scores.gather(-1, idx)
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-20) \
            * cfg.routed_scale
        aux = z = 0.0
    else:
        probs = torch.softmax(logits, dim=-1)

        # --- aux losses (over every row of the groups, padding included)
        top1 = F.one_hot(probs.argmax(dim=-1), e).float()
        aux = cfg.router_aux_coef * e * torch.sum(top1.mean(dim=(0, 1))
                                                  * probs.mean(dim=(0, 1)))
        z = cfg.router_z_coef * torch.logsumexp(logits,
                                                dim=-1).square().mean()

        # --- top-k routing with per-group capacity ---
        gate, idx = torch.topk(probs, k, dim=-1, sorted=True)  # (G, g, k)
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    cap = int(max(k, round(group * cfg.capacity_factor * k / e)))

    # pair j = (token, choice) = (j // k, j % k) over all groups.  A stable
    # sort by (expert, group) keeps each run in token-major, choice-minor
    # order, so a pair's rank in its run is its slot in the expert.
    n = n_g * group * k
    pair_group = torch.arange(n, device=x.device) // (group * k)
    key = idx.reshape(n) * n_g + pair_group
    key_sorted, order = torch.sort(key, stable=True)
    pair_counts = torch.zeros(e * n_g, dtype=torch.int64, device=x.device)
    pair_counts.scatter_add_(0, key, torch.ones_like(key))
    starts = pair_counts.cumsum(0) - pair_counts
    slot = torch.arange(n, device=x.device) - starts[key_sorted]
    keep = torch.empty_like(slot).scatter_(0, order, slot) < cap

    # every pair of a held expert runs through it (a dropped one is
    # weighted 0); the others sort after them, past the last end
    held = cfg.n_held
    per_group = pair_counts.view(e, n_g)[:held]
    per_expert = per_group.sum(dim=1) if counts is None \
        else torch.sum(per_group, dim=1, out=counts)
    offs = per_expert.cumsum(0).to(torch.int32)
    y_sorted = _expert_ffn(p, xt[order // k], offs)
    y = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    weights = torch.where(keep, gate.reshape(n), 0.0)
    out = y.float().view(-1, k, d) * weights.view(-1, k, 1)
    if held < e:
        out = torch.where((idx < held).view(-1, k, 1), out, 0.0)
    out = out.sum(dim=1)[:t].to(x.dtype)

    if p.shared is not None:
        out = out + p.shared(xt[:t])
    return out.reshape(b, s, d), aux + z


def moe_per_row(p: MoE, cfg: ModelConfig, x: torch.Tensor,
                group_size: int = MOE_GROUP, shard=NOSHARD,
                counts: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_fwd`` with each row of x (B, S, d) forming its own groups, as
    the JAX package's engine has it (it maps the one-sequence model over
    the slots): a decode step's token is a group of one, dropless.  Each
    row is padded at its end to whole groups; one call serves all rows.
    The aux loss is taken over all rows' groups together; ``counts`` as
    ``moe_fwd``'s."""
    b, s, d = x.shape
    group = min(group_size, s)
    n_g = -(-s // group)
    if n_g * group != s:
        x = F.pad(x, (0, 0, 0, n_g * group - s))
    rows = x.reshape(b * n_g, group, d)
    if shard.sharded:
        out, aux = moe_sharded(p, cfg, rows, group, shard)
    else:
        out, aux = moe_fwd(p, cfg, rows, group, counts=counts)
    return out.reshape(b, n_g * group, d)[:, :s], aux


def _routed_local(x, router, w_gate, w_up, w_down, *, cfg: ModelConfig,
                  group: int, e0: int, first: bool):
    """The routed experts e0 .. e0 + E_l - 1 (the local w_*) on local
    tokens x (b, s, d), in the capacity layout.  Returns (this rank's share
    of the output (b, s, d) f32 -- its experts' weighted choices --, the
    top-1 counts (E,) and router probabilities summed over the rows (E,),
    and the squared log-sum-exps summed (), all f32; zeros unless
    ``first``, so that their sums over 'model' count one rank's)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    e_l = w_gate.shape[0]
    n_g = -(-t // group)
    xt = x.reshape(t, d)
    if n_g * group != t:
        xt = F.pad(xt, (0, 0, 0, n_g * group - t))
    xg = xt.reshape(n_g, group, d)
    logits = xg.float() @ router                              # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    top1 = F.one_hot(probs.argmax(dim=-1), e).float().sum(dim=(0, 1))
    z = torch.logsumexp(logits, dim=-1).square().sum()
    gate, idx = torch.topk(probs, k, dim=-1, sorted=True)     # (G, g, k)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    cap = int(max(k, round(group * cfg.capacity_factor * k / e)))
    # a pair's slot in its expert: pairs before it in (token, choice) order
    onehot = F.one_hot(idx.reshape(n_g, group * k), e)        # (G, gk, E)
    slot = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(dim=-1)
    slot = slot.view(n_g, group * k)
    pair_e = idx.view(n_g, group * k)
    mine = (pair_e >= e0) & (pair_e < e0 + e_l) & (slot < cap)
    dump = e_l * cap
    dest = torch.where(mine, (pair_e - e0) * cap + slot, dump)
    # dispatch: (G, E_l * C + 1, d), one row for the pairs this rank drops
    src = xg.repeat_interleave(k, dim=1)                       # (G, gk, d)
    buf = xg.new_zeros((n_g, dump + 1, d))
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), src)
    expert_in = buf[:, :dump].view(n_g, e_l, cap, d)          # moe_inner
    hg = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate).float())
    hu = torch.einsum("gecd,edf->gecf", expert_in, w_up).float()
    y = torch.einsum("gecf,efd->gecd", (hg * hu).to(x.dtype), w_down)
    y = torch.cat([y.reshape(n_g, dump, d), y.new_zeros((n_g, 1, d))], 1)
    pair_y = torch.gather(y, 1, dest[..., None].expand(-1, -1, d))
    weights = torch.where(mine, gate.view(n_g, group * k), 0.0)
    out = (pair_y.float().view(-1, k, d) * weights.view(-1, k, 1)).sum(1)
    keep = 1.0 if first else 0.0
    return (out[:t].view(b, s, d), top1 * keep,
            probs.sum(dim=(0, 1)) * keep, z * keep)


def moe_sharded(p: MoE, cfg: ModelConfig, x: torch.Tensor, group_size: int,
                shard) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_fwd`` on DTensors: the routed experts on local shards
    (``_routed_local``), the shared experts and the aux loss on DTensors.
    Tokens stay on their DP shard when every shard holds whole groups, else
    they are gathered (each rank then routes every group)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    group = min(group_size, t)
    mesh = shard.mesh
    ba = shard.batch_axes
    xspec = fit(mesh, (b, s, d), (ba, None, None))
    if xspec[0] is not None and (t // axis_size(mesh, xspec[0])) % group:
        xspec = fit(mesh, (b, s, d), (None, None, None))
    wspec = fit(mesh, tuple(p.w_gate.shape), ("model", None, None))
    e0 = shard.axis_index("model") * (e // axis_size(mesh, "model")) \
        if wspec[0] else 0
    batch = _axes(xspec[0])
    # the output: rows over DP, the experts' shares summed over 'model';
    # the routing sums: summed over DP, one rank's over 'model'
    out_pl = shard.mixed(xspec, partial=("model",) if wspec[0] else ())
    sum_pl = shard.mixed(P(None), partial=batch + ("model",))
    n_rows = -(-t // group) * group
    first = shard.axis_index("model") == 0

    def routed(x, router, w_gate, w_up, w_down):
        return _routed_local(x, router, w_gate, w_up, w_down, cfg=cfg,
                             group=group, e0=e0, first=first)

    # every rank's rows and experts give a partial gradient of the router
    # and the experts (summed over DP; the router over 'model' too) and of
    # x (over 'model', whose ranks hold different experts)
    w_grad = shard.mixed(wspec, partial=batch)
    out, top1, psum, z = shard.local(
        routed, (x, p.router, p.w_gate, p.w_up, p.w_down),
        (xspec, (None, None), wspec, wspec, wspec),
        (out_pl, sum_pl, sum_pl, sum_pl),
        grads=(shard.mixed(xspec, partial=("model",)),
               shard.mixed(P(None, None), partial=batch + ("model",)),
               w_grad, w_grad, w_grad))
    aux = cfg.router_aux_coef * e * torch.sum((top1 / n_rows)
                                              * (psum / n_rows))
    aux = aux + cfg.router_z_coef * z / n_rows
    # the experts' shares summed in f32, then the model dtype
    out = shard.act(out, "act").to(x.dtype)
    if p.shared is not None:
        out = out + mlp_fwd(p.shared, x)
    return out, aux
