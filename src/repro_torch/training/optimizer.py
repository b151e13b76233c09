"""AdamW over dicts of named tensors, with f32 moments over (possibly) bf16
parameters, global-norm clipping and a linear-warmup cosine schedule: the
JAX package's ``training/optimizer.py``.

The update is the reference's, in its order of operations: the gradients
scaled by min(1, clip / (|g| + 1e-9)), the moments and the bias-corrected
step in f32, weight decay on a parameter whose JAX leaf has two axes or
more (the rank of the reference's layer-stacked leaf, which ``ranks`` gives;
a stacked norm scale (L, d) is decayed, ``ln_f`` is not), and the result
cast back to the parameter's dtype.  Unlike the reference it writes the
parameters and the moments in place (no second copy of either), with
``torch._foreach_*`` ops over all tensors at once.  The moments take each
parameter's placement (``zeros_like``): a DTensor parameter gets DTensor
moments sharded as it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay; f32, as ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """m and v (f32 zeros shaped as each parameter) and the step (int32)."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k, p in params.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict[str, torch.Tensor],
                 state: dict, params: dict[str, torch.Tensor],
                 ranks: dict[str, int] | None = None) -> dict:
    """One step: ``params``, ``state["m"]`` and ``state["v"]`` are updated in
    place and ``state["step"]`` advanced.  ``ranks`` maps each name to its
    JAX leaf's rank (``bridge.leaf_ranks``), by default the tensor's own.
    Returns the metrics {"grad_norm", "lr"} (f32 scalars on the device;
    nothing is read back to the host)."""
    names = list(params)
    ranks = ranks or {k: p.dim() for k, p in params.items()}
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    g = torch._foreach_mul([grads[k].float() for k in names], scale)
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - cfg.b2))
    mh = torch._foreach_div(m, b1c)
    vh = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(vh)
    torch._foreach_add_(vh, cfg.eps)
    upd = torch._foreach_div(mh, vh)
    pf = [params[k].float() for k in names]
    decayed = [i for i, k in enumerate(names) if ranks[k] >= 2]
    if decayed:
        torch._foreach_add_([upd[i] for i in decayed], torch._foreach_mul(
            [pf[i] for i in decayed], cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    pf = torch._foreach_sub(pf, upd)
    for k, new in zip(names, pf):
        params[k].copy_(new)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
