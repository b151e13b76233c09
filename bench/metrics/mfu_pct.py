"""Model FLOPs of every real prompt and output token the window processed
(``bench/work.py`` on the counts the configuration's reference module
states: weights per token, attention over each token's real context, other
per-token work such as an SSD recurrence, the head only where logits are
taken), over the window's seconds times the card's bf16 peak, in
percent."""

from bench import work


def read(ro):
    c = ro.counts
    flops = 0.0
    for it in ro.window():
        flops += sum(work.prompt_flops(c, n) for _, n, _ in it.prefills)
        flops += work.step_flops(c, it.running, it.context)
    return flops / (ro.seconds * work.PEAK_FLOPS["bfloat16"]) * 100
