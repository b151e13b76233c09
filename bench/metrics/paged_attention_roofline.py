"""The paged-attention kernel's share of its roofline over the traced
decode steps: the sum of each call's bound (``work.paged_work`` on the
slots' cached lengths, at the bf16 peak and the HBM bandwidth) over the
device time of the kernel's symbol, in percent."""

from bench import work

SYMBOLS = ("paged_split_kernel",)


def read(ro):
    if ro.trace is None:
        return None
    run = ro.run
    hd = run["head_dim"] or run["d_model"] // run["n_heads"]
    slots = ro.mix["slots"]
    per_seq = ro.mix["max_seq"] // ro.page_size
    bound = sum(work.bound_s(*work.paged_work(
        it.lengths, slots, run["n_heads"], run["n_kv_heads"], hd, per_seq),
        "bfloat16") for it in ro.traced if it.running)
    bound *= work.attention_layers(run)
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
