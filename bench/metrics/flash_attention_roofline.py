"""The flash-attention kernel's share of its roofline over the traced
prefills: the sum of each call's bound (``work.flash_work``, causal over
the prefill bucket, at the bf16 peak and the HBM bandwidth) over the device
time of the kernel's symbols, in percent."""

from bench import work

SYMBOLS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(ro):
    if ro.trace is None:
        return None
    run = ro.run
    hd = run["head_dim"] or run["d_model"] // run["n_heads"]
    bound = sum(work.bound_s(*work.flash_work(
        1, bucket, run["n_heads"], run["n_kv_heads"], hd), "bfloat16")
        for it in ro.traced for bucket, _, _ in it.prefills)
    bound *= work.attention_layers(run)
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
