"""Seeded weights drawn on the model's device.

The scheme is ``repro_torch.models.transformer.seeded_init``'s, copied and
frozen here: the embedding N(0, 0.02), every other parameter of two or more
axes N(0, 1/fan_in) with fan_in its next-to-last axis.  The 1-D parameters
keep the values the modules set, except a Mamba2 layer's ``dt_bias``, which
takes Mamba2's published initialisation from the configuration's
``time_step_min``, ``time_step_max`` and ``time_step_floor``: dt log-uniform
in [min, max], floored, and ``dt_bias`` = softplus^-1(dt).  A configuration
may name its residual branches' output projections (``residual_out``:
``{"suffixes": [...], "scale": s}``): those are drawn N(0, s^2/fan_in), so
that a deep pre-norm stack of random layers stays near its float32 values
in bfloat16 instead of turning chaotic.

Numbers are drawn by a ``torch.Generator`` on the device, in a few large
calls: one flat buffer per (dtype, scale) group, filled by one call, whose
slices become the parameters.  The modules are built on the CPU, where
``torch.empty`` reserves nothing, so no weight is made twice and none
crosses from the host."""

from __future__ import annotations

import math

import torch
from torch import nn


def _scale(name: str, param: torch.Tensor, residual_out: dict | None
           ) -> float:
    if name == "embed":
        return 0.02
    std = 1.0 / math.sqrt(param.shape[-2])
    if residual_out and name.endswith(tuple(residual_out["suffixes"])):
        std *= residual_out["scale"]
    return std


def fill(net: nn.Module, seed: int, device: torch.device,
         dt_init: dict | None = None,
         residual_out: dict | None = None) -> nn.Module:
    """Move ``net`` (built on the CPU) to ``device`` with every weight of two
    or more axes drawn there from ``seed``; ``dt_init`` ({"min", "max",
    "floor"}) sets each ``*.dt_bias`` as Mamba2 initialises it;
    ``residual_out`` scales the named output projections."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups: dict[tuple, list[tuple[nn.Module, str, torch.Tensor]]] = {}
    for mod_name, mod in net.named_modules():
        for pname, param in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{pname}" if mod_name else pname
            if param.dim() >= 2:
                key = (param.dtype, _scale(full, param, residual_out))
                groups.setdefault(key, []).append((mod, pname, param))
    for (dtype, std), leaves in groups.items():
        flat = torch.empty(sum(p.numel() for _, _, p in leaves),
                           dtype=dtype, device=device)
        flat.normal_(0.0, std, generator=gen)
        off = 0
        for mod, pname, param in leaves:
            view = flat[off:off + param.numel()].view(param.shape)
            mod._parameters[pname] = nn.Parameter(view, requires_grad=False)
            off += param.numel()
    net.to(device)
    if dt_init is not None:
        biases = [p for n, p in net.named_parameters()
                  if n.endswith("dt_bias")]
        if biases:
            u = torch.rand(sum(b.numel() for b in biases),
                           dtype=torch.float32, device=device,
                           generator=gen)
            lo, hi = math.log(dt_init["min"]), math.log(dt_init["max"])
            dt = torch.exp(u * (hi - lo) + lo).clamp(min=dt_init["floor"])
            inv = dt + torch.log(-torch.expm1(-dt))
            off = 0
            with torch.no_grad():
                for b in biases:
                    b.copy_(inv[off:off + b.numel()])
                    off += b.numel()
    return net
