"""Host time of every ``InferenceEngine._step`` in the window over their
count; each ends in its copy of the next tokens to the host."""


def read(ro):
    steps = [it.step_s for it in ro.window() if it.running]
    return sum(steps) / len(steps) * 1e3 if steps else None
