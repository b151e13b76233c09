"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM +
sLSTM), the JAX package's ``ssm.py``.

Mamba2: counterparts of ``mamba2_init`` (the ``Mamba2`` module and its 1-D
parameters), ``_split_mamba_proj``, ``mamba2_fwd`` (full sequence, with an
optional initial state, the scan through ``ops.ssd_scan``: the CUDA kernel on
the card, the chunked plain version on the CPU) and ``mamba2_step`` (the
O(1) decode update, plain PyTorch ops, as the JAX package has no kernel
there).  As in the reference: no short conv1d in front of x/B/C, one B/C
group shared by all heads, the state (b, h, p, n) in f32.  The port's
nemotron_h options (``ModelConfig``): ``conv_kernel`` taps of a causal
depthwise conv with bias over x, B and C, then silu (``causal_conv``; its
state, the last taps - 1 inputs, rolled in place); ``ssm_groups`` B/C
groups, head i reading group i // (H / G); ``gated_group_norm``, the
published tail.

xLSTM: ``MLSTM`` / ``mlstm_fwd`` (matrix memory, exponential gating) and
``SLSTM`` / ``slstm_fwd`` (scalar memory with a per-head dense hidden-state
recurrence), each a Python loop over time with the step of the reference's
``lax.scan``, the states in f32 and the stabiliser ``m`` starting at -1e30;
``XLSTMPair`` is one (mLSTM, sLSTM) pair of the stack.  The mLSTM's head
dimension is ``d_model // n_heads``, as in the reference.

Under a mesh (``shard``) the SSD scan and the Mamba2 step run on each
rank's local heads, and the xLSTM recurrences on each rank's local rows
(``shard.local``); the projections around them run on DTensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, dtype_of, rmsnorm, weight
from repro_torch.parallel.sharding import (
    NOSHARD,
    P,
    _axes,
    axis_size,
    fit,
    placements,
)


class Mamba2(nn.Module):
    """in_proj -> [z (di), x (di), B (G n), C (G n), dt (h)]; out_proj (di,
    d); with a conv, ``conv_w`` (taps, di + 2 G n) and ``conv_b`` (di + 2 G
    n) in the model dtype (the bias 0).  ``A_log``, ``D`` and ``dt_bias``
    stay f32 in a bf16 model and start as the reference's: log(linspace(1,
    16, h)), ones, zeros."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        d, di = cfg.d_model, cfg.d_inner
        gn, h = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
        self.in_proj = weight((d, 2 * di + 2 * gn + h), dt, device)
        if cfg.conv_kernel:
            self.conv_w = weight((cfg.conv_kernel, di + 2 * gn), dt, device)
            self.conv_b = nn.Parameter(torch.zeros(di + 2 * gn, dtype=dt,
                                                   device=device),
                                       requires_grad=False)
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
    """z, xBC (x, B and C, the conv's input) and dt."""
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * gn], \
        proj[..., 2 * di + 2 * gn:]


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    """x (..., di) and B, C in f32: (..., n) with one group, else (..., G,
    n)."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    B, C = xbc[..., di:di + g * n].float(), xbc[..., di + g * n:].float()
    if g > 1:
        B, C = B.unflatten(-1, (g, n)), C.unflatten(-1, (g, n))
    return xbc[..., :di], B, C


def causal_conv(p: Mamba2, xbc: torch.Tensor,
                state: torch.Tensor | None = None) -> torch.Tensor:
    """silu of the causal depthwise conv over xbc (b, l, ch) with bias, in
    f32 -> (b, l, ch).  ``state`` (b, taps - 1, ch), the inputs before xbc
    (zeros where None), takes the last taps - 1 inputs, in place: a decode
    step rolls it, a prefill leaves its prompt's tail."""
    taps = p.conv_w.shape[0]
    b, l, ch = xbc.shape
    prev = state if state is not None else xbc.new_zeros((b, taps - 1, ch))
    full = torch.cat([prev, xbc], dim=1)                     # (b, l+t-1, ch)
    win = full.float().unfold(1, taps, 1)                    # (b, l, ch, t)
    out = (win * p.conv_w.t().float()).sum(-1) + p.conv_b.float()
    if state is not None:
        state.copy_(full[:, l:])
    return F.silu(out)


def _gate_and_project(p: Mamba2, cfg: ModelConfig, y: torch.Tensor,
                      z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The shared tail of both paths.  zamba2: cast, RMSNorm, the gate,
    out_proj.  ``gated_group_norm``: the gate on f32 y, RMSNorm over each
    group's channels, cast, out_proj."""
    if cfg.gated_group_norm:
        g = cfg.ssm_groups
        y = y * F.silu(z.float())
        y = rmsnorm(y.unflatten(-1, (g, -1)), p.norm.scale.view(g, -1),
                    cfg.norm_eps).flatten(-2)
        return y.to(dtype) @ p.out_proj
    y = p.norm(y.to(dtype))
    y = y * F.silu(z.float()).to(dtype)
    return y @ p.out_proj


def _head_axis(shard, h: int):
    """'model' when the heads divide it, else None (heads whole)."""
    return "model" if h % axis_size(shard.mesh, "model") == 0 else None


def mamba2_fwd(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
               state: torch.Tensor | None = None, chunk: int = 128,
               shard=NOSHARD, conv: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block.  u: (b, l, d) -> (y (b, l, d), final
    state (b, h, p, n) f32).  A ragged l is padded inside the scan with
    a = 0 and x = 0, as the reference pads it.  With a conv, ``conv`` is
    its state (``causal_conv``), updated in place."""
    b, l, _ = u.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u @ p.in_proj
    z, xbc, dt = _split_mamba_proj(cfg, proj)
    if cfg.conv_kernel:
        xbc = causal_conv(p, xbc, conv)
    x, Bf, Cf = _split_xbc(cfg, xbc)
    dt = F.softplus(dt.float() + p.dt_bias)                      # (b,l,h)
    A = -torch.exp(p.A_log)                                      # (h,)
    a = dt * A                                                   # (b,l,h)
    xr = shard.heads(x, (b, l, h, pdim)).float()
    xh = xr * dt[..., None]                                      # fold dt

    def scan(xh, a, Bf, Cf, state):
        return ops.ssd_scan(xh.contiguous(), a, Bf.contiguous(),
                            Cf.contiguous(), state, chunk)

    if shard.sharded:
        ba, hx = shard.batch_axes, _head_axis(shard, h)
        specs = ((ba, None, hx, None), (ba, None, hx), (ba, None, None),
                 (ba, None, None), (ba, hx, None, None))
        outs = (fit(shard.mesh, tuple(xh.shape), specs[0]),
                fit(shard.mesh, (b, h, pdim, cfg.ssm_state), specs[4]))
        # each rank's heads give a partial gradient of the shared B and C
        bc = shard.mixed(fit(shard.mesh, tuple(Bf.shape), specs[2]),
                         partial=(hx,) if hx else ())
        y, final = shard.local(scan, (xh, a, Bf, Cf, state), specs, outs,
                               grads=(None, None, bc, bc, None))
    else:
        y, final = scan(xh, a, Bf, Cf, state)
    y = y + (xr if cfg.gated_group_norm else xh) * p.D[None, None, :, None]
    return _gate_and_project(p, cfg, y.reshape(b, l, cfg.d_inner), z,
                             u.dtype), final


def mamba2_step(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                state: torch.Tensor, shard=NOSHARD,
                conv: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) decode step.  u: (b, 1, d); state: (b, h, p, n) f32 ->
    (y (b, 1, d), new state).  With a conv, ``conv`` (b, taps - 1, ch) is
    its state, rolled in place."""
    b = u.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u[:, 0] @ p.in_proj                                   # (b, .)
    z, xbc, dt = _split_mamba_proj(cfg, proj)
    if cfg.conv_kernel:
        xbc = causal_conv(p, xbc[:, None], conv)[:, 0]
    x, Bf, Cf = _split_xbc(cfg, xbc)
    dt = F.softplus(dt.float() + p.dt_bias)                      # (b,h)
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A)                                       # (b,h)
    xr = shard.heads(x, (b, h, pdim)).float()
    xh = xr * dt[..., None]
    # one B and C for every head, or each head its group's
    ein = ("bhp,bn->bhpn", "bhpn,bn->bhp")
    if cfg.ssm_groups > 1:
        Bf, Cf = (t.repeat_interleave(h // cfg.ssm_groups, dim=1)
                  for t in (Bf, Cf))
        ein = ("bhp,bhn->bhpn", "bhpn,bhn->bhp")

    def update(state, da, xh, Bf, Cf):
        # s = s * da + x (x) B
        new_state = (state * da[..., None, None]
                     + torch.einsum(ein[0], xh, Bf))
        return new_state, torch.einsum(ein[1], new_state, Cf)

    if shard.sharded:
        ba, hx = shard.batch_axes, _head_axis(shard, h)
        specs = ((ba, hx, None, None), (ba, hx), (ba, hx, None),
                 (ba, None), (ba, None))
        outs = (fit(shard.mesh, tuple(state.shape), specs[0]),
                fit(shard.mesh, tuple(xh.shape), specs[2]))
        new_state, y = shard.local(update, (state, da, xh, Bf, Cf), specs,
                                   outs)
    else:
        new_state, y = update(state, da, xh, Bf, Cf)
    y = y + (xr if cfg.gated_group_norm else xh) * p.D[None, :, None]
    out = _gate_and_project(p, cfg, y.reshape(b, cfg.d_inner), z, u.dtype)
    return out[:, None], new_state


class MambaLayer(nn.Module):
    """One backbone layer of the hybrid: pre-norm Mamba2 with a residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype_of(cfg), device)
        self.mamba = Mamba2(cfg, device)

    def forward(self, x: torch.Tensor, state: torch.Tensor | None = None,
                shard=NOSHARD, conv: torch.Tensor | None = None
                ) -> torch.Tensor:
        """Without ``state``: the full sequence from a zero state.  With
        it: one token steps the state, a longer slab scans from it; either
        way the new state is written into ``state`` in place (the JAX
        package returns a new array), and a conv's state into ``conv``."""
        h = self.ln(x)
        if state is None:
            y, _ = mamba2_fwd(self.mamba, self.cfg, h, shard=shard)
            return x + shard.act(y, "act")
        if x.shape[1] == 1:
            y, new = mamba2_step(self.mamba, self.cfg, h, state, shard, conv)
        else:
            y, new = mamba2_fwd(self.mamba, self.cfg, h, state, shard=shard,
                                conv=conv)
        shard.write(state, new)
        return x + shard.act(y, "act")



# ======================================================================
# xLSTM: mLSTM + sLSTM
# ======================================================================

class MLSTM(nn.Module):
    """q/k/v, output and output-gate projections (d, d) in the model dtype;
    input and forget gate weights ``w_i``/``w_f`` (d, h) and ``f_bias``
    (h,) = 3.0 (forget by default) in f32."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        dt = dtype_of(cfg)
        d, h = cfg.d_model, cfg.n_heads
        self.wq = weight((d, d), dt, device)
        self.wk = weight((d, d), dt, device)
        self.wv = weight((d, d), dt, device)
        self.w_i = weight((d, h), torch.float32, device)
        self.w_f = weight((d, h), torch.float32, device)
        self.w_o = weight((d, d), dt, device)
        self.w_up = weight((d, d), dt, device)
        self.f_bias = nn.Parameter(torch.full((h,), 3.0, device=device),
                                   requires_grad=False)


def _rows(shard, fn, args, out_shapes):
    """``fn(*args)`` on each rank's local rows (dim 0), every other dim
    whole; out_shapes are the outputs' global shapes."""
    if not shard.sharded:
        return fn(*args)
    ba = shard.batch_axes
    specs = tuple(None if a is None else (ba,) + (None,) * (a.dim() - 1)
                  for a in args)
    outs = tuple(fit(shard.mesh, o, (ba,) + (None,) * (len(o) - 1))
                 for o in out_shapes)
    return shard.local(fn, args, specs, outs)


def mlstm_fwd(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
              state: tuple | None = None, shard=NOSHARD
              ) -> tuple[torch.Tensor, tuple]:
    """x: (b, l, d) -> (out (b, l, d), (C (b,h,dh,dh), n (b,h,dh), m
    (b,h))), the stabilised recurrence one step per token."""
    b, l, d = x.shape
    h = cfg.n_heads
    dh = d // h
    q = shard.heads(x @ p.wq, (b, l, h, dh)).float() / math.sqrt(dh)
    k = shard.heads(x @ p.wk, (b, l, h, dh)).float() / math.sqrt(dh)
    v = shard.heads(x @ p.wv, (b, l, h, dh)).float()
    i_pre = x.float() @ p.w_i
    f_pre = x.float() @ p.w_f + p.f_bias
    shapes = ((b, l, h, dh), (b, h, dh, dh), (b, h, dh), (b, h))
    hs, C, n, m = _rows(shard, _mlstm_scan,
                        (q, k, v, i_pre, f_pre) + tuple(state or (None,) * 3),
                        shapes)
    gate = F.silu((x @ p.w_up).float())
    out = (hs.reshape(b, l, d) * gate).to(x.dtype)
    return out @ p.w_o, (C, n, m)


def _mlstm_scan(q, k, v, i_pre, f_pre, C, n, m):
    """The mLSTM recurrence: (hs (b, l, h, dh), C, n, m)."""
    b, l, h, dh = q.shape
    if C is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        C, n, m = (torch.zeros((b, h, dh, dh), **f32),
                   torch.zeros((b, h, dh), **f32),
                   torch.full((b, h), -1e30, **f32))
    hs = []
    for t in range(l):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]                # (b,h,dh)
        it, ft = i_pre[:, t], f_pre[:, t]                     # (b,h)
        log_f = -F.softplus(-ft)                              # log sigmoid
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        C = f_s[..., None, None] * C + i_s[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])              # (b,h,dv,dk)
        n = f_s[..., None] * n + i_s[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, dim=1), C, n, m


class SLSTM(nn.Module):
    """Input weights of the z, i, f, o gates stacked ``w_x`` (d, 4d), per-
    head recurrent weights ``r_h`` (h, dh, 4dh) and ``bias`` (4d,) with its
    forget quarter 3.0, all f32; ``w_o`` (d, d) in the model dtype."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        self.w_x = weight((d, 4 * d), torch.float32, device)
        self.r_h = weight((h, dh, 4 * dh), torch.float32, device)
        bias = torch.zeros(4 * d, device=device)
        bias[2 * d:3 * d] = 3.0
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.w_o = weight((d, d), dtype_of(cfg), device)


def slstm_fwd(p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
              state: tuple | None = None, shard=NOSHARD
              ) -> tuple[torch.Tensor, tuple]:
    """x: (b, l, d) -> (out (b, l, d), (c, n, h, m) each (b, d)), the
    scalar-memory recurrence one step per token."""
    b, l, d = x.shape
    pre_x = x.float() @ p.w_x + p.bias                        # (b,l,4d)
    r_h = p.r_h
    if shard.sharded:
        # the recurrent weights whole on every rank; each rank's rows give
        # a partial gradient
        rows = fit(shard.mesh, (b,), (shard.batch_axes,))[0]
        whole = P(None, None, None)
        r_h = r_h.redistribute(shard.mesh, placements(shard.mesh, whole))
        r_h = r_h.to_local(grad_placements=shard.mixed(
            whole, partial=_axes(rows)))
    hs, *new = _rows(shard, lambda pre_x, *st: _slstm_scan(
        pre_x, r_h, cfg.n_heads, *st),
        (pre_x,) + tuple(state or (None,) * 4), ((b, l, d),) + ((b, d),) * 4)
    out = hs.to(x.dtype) @ p.w_o
    return out, tuple(new)


def _slstm_scan(pre_x, r_h, h, c, n, hprev, m):
    """The sLSTM recurrence: (hs (b, l, d), c, n, h, m)."""
    b, l, d4 = pre_x.shape
    d = d4 // 4
    dh = d // h
    if c is None:
        f32 = dict(dtype=torch.float32, device=pre_x.device)
        c, n, hprev = (torch.zeros((b, d), **f32) for _ in range(3))
        m = torch.full((b, d), -1e30, **f32)
    hs = []
    for t in range(l):
        rec = torch.einsum("bhd,hde->bhe", hprev.reshape(b, h, dh),
                           r_h).reshape(b, 4 * d)
        zt, it, ft, ot = (pre_x[:, t] + rec).chunk(4, dim=-1)
        zt = torch.tanh(zt)
        log_f = -F.softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        hprev = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=1), c, n, hprev, m


MLSTM_STATE = ("mlstm_C", "mlstm_n", "mlstm_m")
SLSTM_STATE = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")


class XLSTMPair(nn.Module):
    """One pair of the xLSTM stack: pre-norm mLSTM and pre-norm sLSTM,
    each with a residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.ln_m = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.mlstm = MLSTM(cfg, device)
        self.ln_s = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.slstm = SLSTM(cfg, device)

    def forward(self, x: torch.Tensor, states: dict | None = None,
                shard=NOSHARD) -> torch.Tensor:
        """Without ``states``: from zero states.  With them (this pair's
        ``MLSTM_STATE`` and ``SLSTM_STATE`` tensors, batch first): from
        them, and the new states are written into them in place (the JAX
        package returns new arrays)."""
        m_state = s_state = None
        if states is not None:
            m_state = tuple(states[k] for k in MLSTM_STATE)
            s_state = tuple(states[k] for k in SLSTM_STATE)
        y, new_m = mlstm_fwd(self.mlstm, self.cfg, self.ln_m(x), m_state,
                             shard)
        x = x + shard.act(y, "act")
        y, new_s = slstm_fwd(self.slstm, self.cfg, self.ln_s(x), s_state,
                             shard)
        if states is not None:
            for name, new in zip(MLSTM_STATE + SLSTM_STATE, new_m + new_s):
                shard.write(states[name], new)
        return x + shard.act(y, "act")
