"""The paged-attention kernel's share of its roofline over the traced
decode steps: the sum of each call's bound (``work.paged_work`` on the
slots' cached lengths, at the bf16 peak and the HBM bandwidth), one call
per attention application of each kind the reference module counts, over
the device time of the kernel's symbol, in percent."""

from bench import work

SYMBOLS = ("paged_split_kernel",)


def read(ro):
    if ro.trace is None:
        return None
    slots = ro.mix["slots"]
    per_seq = ro.mix["max_seq"] // ro.page_size
    bound = sum(n * sum(work.bound_s(*work.paged_work(
        it.lengths, slots, hq, hkv, hd, per_seq), "bfloat16")
        for it in ro.traced if it.running)
        for n, hq, hkv, hd in ro.counts.attention)
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
