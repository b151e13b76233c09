"""Mamba2 (SSD): the state-space half of the JAX package's ``ssm.py``.

Counterparts of ``mamba2_init`` (the ``Mamba2`` module and its 1-D
parameters), ``_split_mamba_proj``, ``mamba2_fwd`` (full sequence, with an
optional initial state, the scan through ``ops.ssd_scan``: the CUDA kernel on
the card, the chunked plain version on the CPU) and ``mamba2_step`` (the
O(1) decode update, plain PyTorch ops, as the JAX package has no kernel
there).  As in the reference: no short conv1d in front of x/B/C, one B/C
group shared by all heads, the state (b, h, p, n) in f32.  xLSTM is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, dtype_of, weight


class Mamba2(nn.Module):
    """in_proj -> [z (di), x (di), B (n), C (n), dt (h)]; out_proj (di, d).
    ``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 model and start as
    the reference's: log(linspace(1, 16, h)), ones, zeros."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        d, di = cfg.d_model, cfg.d_inner
        n, h = cfg.ssm_state, cfg.ssm_heads
        self.in_proj = weight((d, 2 * di + 2 * n + h), dt, device)
        self.out_proj = weight((di, d), dt, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h,
                                                           **f32)),
                                  requires_grad=False)
        self.D = nn.Parameter(torch.ones(h, **f32), requires_grad=False)
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32),
                                    requires_grad=False)
        self.norm = RMSNorm(di, cfg.norm_eps, dt, device)


def _split_mamba_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    B = proj[..., 2 * di:2 * di + n]
    C = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, x, B, C, dt


def _gate_and_project(p: Mamba2, cfg: ModelConfig, y: torch.Tensor,
                      z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The shared tail of both paths: cast, gated RMSNorm, out_proj."""
    y = p.norm(y.to(dtype))
    y = y * F.silu(z.float()).to(dtype)
    return y @ p.out_proj


def mamba2_fwd(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
               state: torch.Tensor | None = None, chunk: int = 128
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block.  u: (b, l, d) -> (y (b, l, d), final
    state (b, h, p, n) f32).  A ragged l is padded inside the scan with
    a = 0 and x = 0, as the reference pads it."""
    b, l, _ = u.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u @ p.in_proj
    z, x, B, C, dt = _split_mamba_proj(cfg, proj)
    dt = F.softplus(dt.float() + p.dt_bias)                      # (b,l,h)
    A = -torch.exp(p.A_log)                                      # (h,)
    a = dt * A                                                   # (b,l,h)
    xh = x.reshape(b, l, h, pdim).float() * dt[..., None]        # fold dt
    y, final = ops.ssd_scan(xh.contiguous(), a, B.float().contiguous(),
                            C.float().contiguous(), state, chunk)
    y = y + xh * p.D[None, None, :, None]
    return _gate_and_project(p, cfg, y.reshape(b, l, cfg.d_inner), z,
                             u.dtype), final


def mamba2_step(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode step.  u: (b, 1, d); state: (b, h, p, n) f32 ->
    (y (b, 1, d), new state)."""
    b = u.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u[:, 0] @ p.in_proj                                   # (b, .)
    z, x, B, C, dt = _split_mamba_proj(cfg, proj)
    dt = F.softplus(dt.float() + p.dt_bias)                      # (b,h)
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A)                                       # (b,h)
    xh = x.reshape(b, h, pdim).float() * dt[..., None]
    # s = s * da + x (x) B
    new_state = (state * da[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xh, B.float()))
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    y = y + xh * p.D[None, :, None]
    out = _gate_and_project(p, cfg, y.reshape(b, cfg.d_inner), z, u.dtype)
    return out[:, None], new_state


class MambaLayer(nn.Module):
    """One backbone layer of the hybrid: pre-norm Mamba2 with a residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype_of(cfg), device)
        self.mamba = Mamba2(cfg, device)

    def forward(self, x: torch.Tensor,
                state: torch.Tensor | None = None) -> torch.Tensor:
        """Without ``state``: the full sequence from a zero state.  With
        it: one token steps the state, a longer slab scans from it; either
        way the new state is written into ``state`` in place (the JAX
        package returns a new array)."""
        h = self.ln(x)
        if state is None:
            y, _ = mamba2_fwd(self.mamba, self.cfg, h)
            return x + y
        step = mamba2_step if x.shape[1] == 1 else mamba2_fwd
        y, new = step(self.mamba, self.cfg, h, state)
        state.copy_(new)
        return x + y

