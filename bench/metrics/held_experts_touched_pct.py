"""Share of the held experts that took at least one routed pair in a decode
step: each step's touched experts over the held experts times the MoE
layers, as the program books them at the step's read-back
(``repro_torch.obs.EXPERT_STEPS``: every row of the step, idle slots
included), a mean over the window's decode steps, in percent.  None where
the program keeps no such record or the window holds no MoE step.

A diagnostic of the routing under the traffic, not of the program's
speed: the model's router and the mix set it, so it must not move.  A
change in it means the program routes differently, which is a fault;
``expert_roofline`` and ``step_device_ms`` read the experts' efficiency."""

from bench import program_spans


def steps(t0: float, t1: float) -> list | None:
    """The program's expert steps booked between host times t0 and t1 (s),
    or None."""
    try:
        from repro_torch.obs import EXPERT_STEPS
    except ImportError:
        return None
    return EXPERT_STEPS.within(program_spans._ns(t0), program_spans._ns(t1))


def read(ro):
    got = steps(ro.t_open, ro.t_close)
    if not got:
        return None
    return sum(s.touched / s.held for s in got) / len(got) * 100
