"""Model FLOPs of every real prompt and output token the window processed
(``bench/work.py``: weights per token, attention over each token's real
context, the SSD recurrence, the head only where logits are taken), over
the window's seconds times the card's bf16 peak, in percent."""

from bench import work


def read(ro):
    flops = 0.0
    for it in ro.window():
        flops += sum(work.prompt_flops(ro.run, n) for _, n, _ in it.prefills)
        flops += work.step_flops(ro.run, it.running, it.context)
    return flops / (ro.seconds * work.PEAK_FLOPS["bfloat16"]) * 100
