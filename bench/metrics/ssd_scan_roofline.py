"""The SSD-scan kernels' share of their roofline over the traced prefills:
the sum of each call's bound (``work.ssd_work`` on the prefill bucket, with
an initial state, at the f32 peak and the HBM bandwidth), one call per SSD
layer of each kind the reference module counts, over the device time of
its three kernels, in percent.  Silent for a model without SSD layers."""

from bench import work

SYMBOLS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_output")


def read(ro):
    if ro.trace is None or not ro.counts.ssd:
        return None
    bound = sum(n * sum(work.bound_s(*work.ssd_work(
        1, bucket, h, p, state, True, groups), "float32")
        for it in ro.traced for bucket, _, _ in it.prefills)
        for n, h, p, state, groups in ro.counts.ssd)
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
