"""The SSD-scan kernels' share of their roofline over the traced prefills:
the sum of each call's bound (``work.ssd_work`` on the prefill bucket, with
an initial state, at the f32 peak and the HBM bandwidth) over the device
time of its three kernels, in percent."""

from bench import work

SYMBOLS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_output")


def read(ro):
    if ro.trace is None or ro.run["family"] != "hybrid":
        return None
    run = ro.run
    di = run["ssm_expand"] * run["d_model"]
    h = di // run["ssm_head_dim"]
    bound = sum(work.bound_s(*work.ssd_work(
        1, bucket, h, run["ssm_head_dim"], run["ssm_state"], True),
        "float32") for it in ro.traced for bucket, _, _ in it.prefills)
    bound *= run["n_layers"]
    dev = ro.kernel_s(SYMBOLS)
    return bound / dev * 100 if dev > 0 and bound > 0 else None
