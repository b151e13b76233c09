"""Host time of every ``InferenceEngine._prefill`` in the window over their
count; each ends in its copy of the first token to the host."""


def read(ro):
    calls = [s for it in ro.window() for _, _, s in it.prefills]
    return sum(calls) / len(calls) * 1e3 if calls else None
