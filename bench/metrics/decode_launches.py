"""Device kernels launched inside the traced decode steps' host spans, per
step, counted by the profiler (each kernel's correlation id leads back to
its launch)."""


def read(ro):
    steps = sum(1 for it in ro.traced if it.running)
    if ro.trace is None or not steps:
        return None
    return ro.trace.launched_in("decode_step") / steps
