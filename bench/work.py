"""The yardstick's arithmetic: the card's peaks, a kernel's bound, the work
of each kernel call from its shapes, and a model's FLOPs per token.

``bound``, the peaks and the flash, paged and SSD work counts are copied
from ``chip_smoke.py`` (its ``bound``, ``PEAK_*``, ``flash_case``'s and
``paged_case``'s counts and ``ssd_work``) and frozen here, so that a change
to the smoke script cannot move the benchmark.  Every input byte is counted
once and every output byte once."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, f32 outside the
# tensor cores 67 TFLOP/s, HBM3 3.35 TB/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
SSD_CHUNK = 128          # mamba2_fwd's chunk: the SSD kernel's tile


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the dtype's peak and bytes over the memory bandwidth (seconds)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def flash_work(b: int, s: int, hq: int, hkv: int, d: int, elt: int = 2,
               causal: bool = True) -> tuple[float, float]:
    """Causal flash attention of q (b, s, hq, d) over k/v (b, s, hkv, d):
    QK^T and PV over the lower triangle; q, k, v read once, o written
    once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * d * hq * b * pairs
    nbytes = float(elt * (2 * b * s * hq * d + 2 * b * s * hkv * d))
    return flops, nbytes


def paged_work(live: int, b: int, hq: int, hkv: int, d: int, per_seq: int,
               elt: int = 2) -> tuple[float, float]:
    """One paged-attention call over ``b`` rows of one query token, which
    attend ``live`` cached positions in all: the live K and V read once, q
    read and o written once, the block table and lengths read once."""
    flops = 4.0 * d * hq * live
    nbytes = float(2 * live * hkv * d * elt + 2 * b * hq * d * elt
                   + b * per_seq * 4 + b * 4)
    return flops, nbytes


def ssd_work(b: int, l: int, h: int, p: int, n: int,
             init: bool) -> tuple[float, float]:
    """FLOP and bytes the SSD scan needs on these shapes: C B^T once per
    batch and chunk (B and C are shared by the heads), G x, C S^T and
    x^T B per head, lower triangles only, a ragged last chunk as long as
    it is; every input read once and every output written once.  Its bound
    takes the f32 peak: the kernel's products are IEEE f32 FMAs."""
    flops = 0.0
    for c0 in range(0, l, SSD_CHUNK):
        lc = min(SSD_CHUNK, l - c0)
        tri = lc * (lc + 1) / 2
        flops += b * tri * n * 2
        flops += b * h * (tri * p * 2 + 2 * lc * n * p * 2)
    states = (2 if init else 1) * b * h * p * n
    nbytes = 4.0 * (2 * b * l * h * p + b * l * h + 2 * b * l * n + states)
    return flops, nbytes


def matmul_params(run: dict) -> int:
    """Weights a token multiplies through in one forward pass, without
    the embedding lookup and the head: attention projections, MLPs, the
    Mamba2 projections, and for an MoE layer the router, the top-k routed
    experts and the shared experts."""
    d, hd = run["d_model"], run["head_dim"] or run["d_model"] // run["n_heads"]
    attn = d * run["n_heads"] * hd * 2 + d * run["n_kv_heads"] * hd * 2
    if run["family"] == "hybrid":
        di = run["ssm_expand"] * d
        n, h = run["ssm_state"], di // run["ssm_head_dim"]
        mamba = d * (2 * di + 2 * n + h) + di * d
        shared = attn + 3 * d * run["d_ff"]
        return run["n_layers"] * mamba \
            + (run["n_layers"] // run["attn_every"]) * shared
    if run["n_experts"]:
        f = run["expert_d_ff"]
        ffn = d * run["n_experts"] + run["top_k"] * 3 * d * f \
            + run["n_shared_experts"] * 3 * d * f
        return run["n_layers"] * (attn + ffn)
    return run["n_layers"] * (attn + 3 * d * run["d_ff"])


def attention_layers(run: dict) -> int:
    """Attention applications in one forward pass."""
    if run["family"] == "hybrid":
        return run["n_layers"] // run["attn_every"]
    return run["n_layers"]


def token_flops(run: dict, context: int, logits: bool) -> float:
    """Model FLOPs of one token at ``context`` attended positions (itself
    included): 2 per weight it multiplies through, 4 * head dim * heads per
    attended position and attention layer, 4 * h * p * n per Mamba2 layer
    for the SSD recurrence (decay and update of the state, and its read),
    and the head (2 * d * vocab) only where its logits are taken."""
    d = run["d_model"]
    hd = run["head_dim"] or d // run["n_heads"]
    flops = 2.0 * matmul_params(run)
    flops += 4.0 * hd * run["n_heads"] * context * attention_layers(run)
    if run["family"] == "hybrid":
        di = run["ssm_expand"] * d
        h = di // run["ssm_head_dim"]
        flops += 4.0 * h * run["ssm_head_dim"] * run["ssm_state"] \
            * run["n_layers"]
    if logits:
        flops += 2.0 * d * run["vocab"]
    return flops


def prompt_flops(run: dict, n: int) -> float:
    """Model FLOPs of a prompt of ``n`` real tokens, the head taken at its
    last token only: token i attends to i + 1 positions."""
    d = run["d_model"]
    hd = run["head_dim"] or d // run["n_heads"]
    attend = 4.0 * hd * run["n_heads"] * attention_layers(run)
    return (n * token_flops(run, 0, False) + attend * n * (n + 1) / 2
            + 2.0 * d * run["vocab"])


def step_flops(run: dict, running: int, context: int) -> float:
    """Model FLOPs of a decode step whose ``running`` tokens attend
    ``context`` real positions in all, each token's logits taken."""
    d = run["d_model"]
    hd = run["head_dim"] or d // run["n_heads"]
    attend = 4.0 * hd * run["n_heads"] * attention_layers(run)
    return running * token_flops(run, 0, True) + attend * context
