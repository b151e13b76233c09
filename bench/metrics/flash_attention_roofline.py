"""The flash-attention kernel's share of its roofline over the traced
prefills: the sum of each call's bound (``work.flash_work``, causal over
the prefill bucket, at the bf16 peak and the HBM bandwidth), one call per
attention application of each kind the reference module counts, over the
device time of the kernel's symbols, in percent."""

from bench import work

SYMBOLS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(ro):
    if ro.trace is None:
        return None
    bound = sum(n * sum(work.bound_s(*work.flash_work(
        1, bucket, hq, hkv, hd), "bfloat16")
        for it in ro.traced for bucket, _, _ in it.prefills)
        for n, hq, hkv, hd in ro.counts.attention)
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
