"""Share of the measured window in which no operation ran on the device, in
percent.

The profiler slows this host-bound loop about twofold, so the traced
iterations after the window are read for device time only: each operation
(kernel, copy, set) is charged to the loop span whose host call issued it,
and each span's device time per unit of its work is scaled to the untraced
window's count of that work: a decode step, a prefill's bucket token, an
iteration for the rest.  Operations overlap little on the engine's one
stream, so their durations are summed."""


def read(ro):
    if ro.trace is None or not ro.traced:
        return None
    by_span = ro.trace.device_s_by_span()
    step = by_span.pop("decode_step", 0.0)
    prefill = by_span.pop("prefill", 0.0)
    rest = sum(by_span.values())
    win = ro.window()

    def count(its):
        return (sum(1 for it in its if it.running),
                sum(b for it in its for b, _, _ in it.prefills), len(its))
    steps_t, tokens_t, iters_t = count(ro.traced)
    steps_w, tokens_w, iters_w = count(win)
    busy = rest / iters_t * iters_w
    if steps_t:
        busy += step / steps_t * steps_w
    if tokens_t:
        busy += prefill / tokens_t * tokens_w
    return (1 - busy / ro.seconds) * 100
