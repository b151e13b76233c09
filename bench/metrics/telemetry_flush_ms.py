"""Host time of every ``InferenceEngine._flush_telemetry`` in the window
over their count: the step's events through the modelled transport into
the DPU sidecar, its detectors, and its commands back."""


def read(ro):
    calls = [it.flush_s for it in ro.window()]
    return sum(calls) / len(calls) * 1e3 if calls else None
