"""Device time of the operations launched inside the program's
``step.enqueue`` spans (each operation's correlation id leads back to its
launch), per traced step: what the decode step leaves the device to do,
the floor under a step whose launches cost the host nothing."""

from bench import program_spans


def read(ro):
    spans = program_spans.traced(ro)
    steps = [(s.start, s.end) for s in spans or ()
             if s.name == "step.enqueue"]
    if not steps:
        return None
    dev = program_spans.device_s_launched_in(ro.trace, steps)
    return dev / len(steps) * 1e3
