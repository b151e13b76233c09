"""The routed experts' grouped GEMMs against their bound over the traced
decode steps.  A step's bound is its bytes over 3.35 TB/s, or its FLOPs
over the bf16 peak where that is larger: the weights of the held experts it
touched (``w_up`` and ``w_down``, d x f each, and ``w_gate`` for SwiGLU
experts, in bf16) and its routed pairs' rows (the input row and the output
row of d, and each f-wide activation written and read), and 2 d f FLOPs a
pair per matrix; the counts are the program's, booked at each step's
read-back (``repro_torch.obs.EXPERT_STEPS``).  The bounds of the traced
steps, summed, over the device time of the grouped GEMM kernels launched
inside the traced ``step.enqueue`` spans, in percent.  Silent where the
program books no expert steps or the trace holds no such kernel."""

import dataclasses

from bench import program_spans, work
from bench.readout import METRICS, module

SYMBOLS = ("enable_3x_kernel_for_sm9",)
ELT = 2


def step_bound_s(run: dict, pairs: int, touched: int) -> float:
    d, f = run["d_model"], run["expert_d_ff"]
    mats = 2 if run.get("expert_act") == "relu2" else 3
    nbytes = ELT * (touched * mats * d * f + pairs * (2 * d + mats * f))
    return work.bound_s(pairs * mats * 2.0 * d * f, nbytes, "bfloat16")


def read(ro):
    spans = program_spans.traced(ro)
    if spans is None:
        return None
    held = module(METRICS / "held_experts_touched_pct.py",
                  "bench_metric_held_experts_touched_pct")
    got = held.steps(ro.traced[0].t0, ro.traced[-1].t1)
    if not got:
        return None
    bound = sum(step_bound_s(ro.run, s.pairs, s.touched) for s in got)
    gemms = dataclasses.replace(ro.trace, ops=[
        o for o in ro.trace.ops if any(sym in o[0] for sym in SYMBOLS)])
    dev = program_spans.device_s_launched_in(
        gemms, [(s.start, s.end) for s in spans if s.name == "step.enqueue"])
    return bound / dev * 100 if dev > 0 else None
