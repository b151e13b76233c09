"""NVIDIA-Nemotron-3-Nano (nemotron_h) in plain float32, as the configuration
file states the port's architecture: the token embedding; one pre-norm
layer per character of ``layer_pattern``, each x <- x + mixer(RMSNorm(x));
the final RMSNorm and an untied head.

M, Mamba2: ``in_proj`` (d, 2 di + 2 G n + h) splits into z (di), xBC (di +
2 G n) and dt (h); xBC = silu(causal depthwise conv over ``conv_kernel``
taps, with bias); xBC splits into x (h heads of p), B and C (G groups of
n), head i reading group i // (h / G); dt = softplus(dt + dt_bias), the
log-decay a = dt * -exp(A_log); the scan s_t = exp(a_t) s_{t-1} + dt_t x_t
B_t^T, y_t = s_t C_t from a zero state, plus D * x (the raw x); y *
silu(z), RMSNorm over each group's di / G channels times the norm weight;
``out_proj``.  No biases but the conv's.

E, MoE: f32 sigmoid scores of h @ router over all E experts; the top k of
scores plus ``router_bias``; gates the chosen scores over their sum (+
1e-20) times ``routed_scale``; each expert relu(h W_up)^2 W_down of width
``expert_d_ff``; one shared expert of width ``shared_d_ff`` alike, added
ungated; dropless.

*, attention: causal GQA, 1/sqrt(D) scaling, no biases, no rotary
embedding.

Departures from the published model, each also the configuration file's:
only ``experts_held`` experts are held, ids 0 onwards (expert
parallelism's share of one chip), so an MoE layer's output is their part of
the routed sum plus the shared expert, the other experts' pairs going
nowhere, as the program computes it; no rotary embedding in attention (an
assumption, see the file); the weights are random.

Experts run one at a time, so an expert's float32 copy is the only
transient of its layer; the scan runs each B/C group's heads through
``hybrid.ssd``'s chunked form.  TF32 is off while a call runs, so every
product is an IEEE float32 one.  ``counts`` states the work of one token
for the yardstick (``bench/work.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.hybrid import ssd
from bench.reference.layers import (attention_weights, f32, head, heads,
                                    rmsnorm)
from bench.work import Counts


class _ieee:
    """TF32 off inside, as ``bench/check.py`` sets it around the check."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self.saved


def values(w) -> torch.Tensor:
    """A weight's float32 values where it is no product operand (the conv):
    the check hands weights of two or more axes as objects that define
    ``x @ w`` and keep their rounded values as ``w``."""
    return getattr(w, "w", w).float()


def sizes(run: dict) -> tuple[int, int, int, int, int]:
    """Mamba2's heads, head dim, state, B/C groups and di."""
    h, p = run["mamba_heads"], run["ssm_head_dim"]
    return h, p, run["ssm_state"], run["ssm_groups"], h * p


def mamba(u: torch.Tensor, q: dict, run: dict) -> torch.Tensor:
    b, l, _ = u.shape
    h, p, n, g, di = sizes(run)
    proj = u @ f32(q["in_proj"])
    z, xbc, dt = (proj[..., :di], proj[..., di:2 * di + 2 * g * n],
                  proj[..., 2 * di + 2 * g * n:])
    w = values(q["conv_w"])                                    # (taps, ch)
    taps = w.shape[0]
    pad = F.pad(xbc, (0, 0, taps - 1, 0))
    xbc = F.silu(sum(pad[:, k:k + l] * w[k] for k in range(taps))
                 + f32(q["conv_b"]))
    x = xbc[..., :di].reshape(b, l, h, p)
    B = xbc[..., di:di + g * n].reshape(b, l, g, n)
    C = xbc[..., di + g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt + f32(q["dt_bias"]))
    a = dt * -torch.exp(f32(q["A_log"]))
    xs = x * dt[..., None]
    hg = h // g
    y = torch.cat([ssd(xs[:, :, i * hg:(i + 1) * hg].contiguous(),
                       a[:, :, i * hg:(i + 1) * hg].contiguous(),
                       B[:, :, i].contiguous(), C[:, :, i].contiguous())
                   for i in range(g)], dim=2)
    y = y + x * f32(q["D"])[:, None]
    y = (y.reshape(b, l, di) * F.silu(z)).reshape(b, l, g, di // g)
    y = rmsnorm(y, q["norm.scale"].reshape(g, di // g), run["norm_eps"])
    return y.reshape(b, l, di) @ f32(q["out_proj"])


def relu2(h: torch.Tensor, w_up, w_down) -> torch.Tensor:
    return torch.relu(h @ f32(w_up)).square() @ f32(w_down)


def route(h: torch.Tensor, q: dict, run: dict
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k experts (..., k) and their gates (..., k) of each token of
    h (..., d), over all E experts."""
    scores = torch.sigmoid(h @ f32(q["router"]))
    idx = torch.topk(scores + f32(q["router_bias"]), run["top_k"],
                     dim=-1).indices
    gate = scores.gather(-1, idx)
    return idx, gate / (gate.sum(-1, keepdim=True) + 1e-20) \
        * run["routed_scale"]


def moe(h: torch.Tensor, q: dict, run: dict) -> torch.Tensor:
    """The routed part of the experts held (ids 0 onwards) plus the shared
    expert."""
    b, l, d = h.shape
    idx, gate = route(h, q, run)
    flat_h = h.reshape(b * l, d)
    flat_idx = idx.reshape(b * l, -1)
    flat_g = gate.reshape(b * l, -1)
    out = torch.zeros_like(flat_h)
    for j in range(run["experts_held"] or run["n_experts"]):
        rows, choice = (flat_idx == j).nonzero(
            as_tuple=True)
        if rows.numel() == 0:
            continue
        y = relu2(flat_h[rows], q["w_up"][j], q["w_down"][j])
        out.index_add_(0, rows, y * flat_g[rows, choice][:, None])
    return out.view(b, l, d) + relu2(h, q["shared.w_up"], q["shared.w_down"])


def attention(h: torch.Tensor, q: dict, run: dict) -> torch.Tensor:
    """Causal GQA self-attention over h (B, L, d), no rotary embedding."""
    b, l, _ = h.shape
    hq, hkv, hd = heads(run)
    qh = (h @ f32(q["wq"])).view(b, l, hq, hd)
    k = (h @ f32(q["wk"])).view(b, l, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    v = (h @ f32(q["wv"])).view(b, l, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    out = torch.empty((b, l, hq, hd), dtype=torch.float32, device=h.device)
    mask = torch.ones((l, l), dtype=torch.bool, device=h.device).tril()
    for i in range(b):   # one sequence at a time keeps the scores small
        s = torch.einsum("qhd,khd->hqk", qh[i], k[i]) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[i] = torch.einsum("hqk,khd->qhd", s, v[i])
    return out.reshape(b, l, hq * hd) @ f32(q["wo"])


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


MIXERS = {"M": ("mamba.", mamba), "E": ("moe.", moe),
          "*": ("attn.", attention)}


def forward(run: dict, params: dict, tokens: torch.Tensor, **_
            ) -> torch.Tensor:
    """tokens (B, L) long -> the last hidden states (B, L, d) before the
    final norm, layer by layer."""
    with _ieee():
        x = f32(params["embed"])[tokens]
        for i, c in enumerate(run["layer_pattern"]):
            lp = _sub(params, f"layers.{i}.")
            prefix, mixer = MIXERS[c]
            x = x + mixer(rmsnorm(x, lp["ln.scale"], run["norm_eps"]),
                          _sub(lp, prefix), run)
        return x


def logits(run: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    with _ieee():
        return head(x, run, params["ln_f.scale"], params["lm_head"])


def counts(run: dict) -> Counts:
    """Per Mamba2 layer ``in_proj`` and ``out_proj``, its SSD scan (h heads
    of p, state n, G B/C groups), the recurrence's 4 h p n FLOPs a token
    and the conv's 2 taps (di + 2 G n); per MoE layer the router (d, E),
    the top-k's share of the experts held here (top_k x held / E relu²
    experts, 2 d f each) and the shared expert (2 d f_s); per attention
    layer its four projections; the head d x vocab."""
    d, pattern = run["d_model"], run["layer_pattern"]
    h, p, n, g, di = sizes(run)
    e, f = run["n_experts"], run["expert_d_ff"]
    held = run["experts_held"] or e
    ch = di + 2 * g * n
    mamba_w = d * (2 * di + 2 * g * n + h) + di * d
    moe_w = d * e + run["top_k"] * held * 2 * d * f // e \
        + 2 * d * run["shared_d_ff"]
    m, a = pattern.count("M"), pattern.count("*")
    return Counts(weights=m * mamba_w + pattern.count("E") * moe_w
                  + a * attention_weights(run),
                  head=d * run["vocab"],
                  attention=((a, *heads(run)),),
                  ssd=((m, h, p, n, g),),
                  other_flops=m * (4.0 * h * p * n
                                   + 2.0 * run["conv_kernel"] * ch))
