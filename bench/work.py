"""The yardstick's arithmetic: the card's peaks, a kernel's bound, the work
of each kernel call from its shapes, and a model's FLOPs from the ``Counts``
that its configuration's reference module states.

``bound``, the peaks and the flash, paged and SSD work counts are copied
from ``chip_smoke.py`` (its ``bound``, ``PEAK_*``, ``flash_case``'s and
``paged_case``'s counts and ``ssd_work``, which here also counts B/C
groups) and frozen here, so that a change to the smoke script cannot move
the benchmark.  Every input byte is counted once and every output byte
once."""

from __future__ import annotations

from dataclasses import dataclass

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


def ssd_work(b: int, l: int, h: int, p: int, n: int, init: bool,
             groups: int = 1) -> tuple[float, float]:
    """FLOP and bytes the SSD scan needs on these shapes: C B^T once per
    batch, chunk and B/C group (each group's B and C are shared by its
    heads), G x, C S^T and x^T B per head, lower triangles only, a ragged
    last chunk as long as it is; every input read once (B and C once per
    group) and every output written once.  Its bound takes the f32 peak:
    the kernel's products are IEEE f32 FMAs."""
    flops = 0.0
    for c0 in range(0, l, SSD_CHUNK):
        lc = min(SSD_CHUNK, l - c0)
        tri = lc * (lc + 1) / 2
        flops += b * groups * tri * n * 2
        flops += b * h * (tri * p * 2 + 2 * lc * n * p * 2)
    states = (2 if init else 1) * b * h * p * n
    nbytes = 4.0 * (2 * b * l * h * p + b * l * h + 2 * b * l * groups * n
                    + states)
    return flops, nbytes


@dataclass(frozen=True)
class Counts:
    """What the yardstick needs of an architecture, as its reference
    module's ``counts(run)`` states it: the weights one token multiplies
    through (the embedding and the head aside); the head's weights; per
    kind of attention layer (applications in one forward pass, query heads,
    KV heads, head dim); per kind of SSD layer (layers, heads, head dim,
    state, B/C groups); and any further FLOPs of one token that do not
    scale with its context."""
    weights: int
    head: int
    attention: tuple = ()
    ssd: tuple = ()
    other_flops: float = 0.0


def attend_flops(c: Counts) -> float:
    """FLOPs of one attended position for one token: 4 * head dim * query
    heads per attention application."""
    return 4.0 * sum(n * hq * hd for n, hq, _, hd in c.attention)


def token_flops(c: Counts, context: int, logits: bool) -> float:
    """Model FLOPs of one token at ``context`` attended positions (itself
    included): 2 per weight it multiplies through, ``attend_flops`` per
    attended position, the architecture's other FLOPs (such as an SSD
    recurrence's), and the head (2 per weight) only where its logits are
    taken."""
    flops = 2.0 * c.weights + attend_flops(c) * context + c.other_flops
    if logits:
        flops += 2.0 * c.head
    return flops


def prompt_flops(c: Counts, n: int) -> float:
    """Model FLOPs of a prompt of ``n`` real tokens, the head taken at its
    last token only: token i attends to i + 1 positions."""
    return (n * token_flops(c, 0, False) + attend_flops(c) * n * (n + 1) / 2
            + 2.0 * c.head)


def step_flops(c: Counts, running: int, context: int) -> float:
    """Model FLOPs of a decode step whose ``running`` tokens attend
    ``context`` real positions in all, each token's logits taken."""
    return running * token_flops(c, 0, True) + attend_flops(c) * context
